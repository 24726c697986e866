"""Host-side frame views — the reference's degree-based data model.

A copy of ``rsoccer_tpu/core/frame.py``'s ``Ball``, ``Robot`` and
``Frame`` (the reference's Entities/Ball.py, Entities/Robot.py,
Entities/Frame.py): plain Python objects in the reference's units (meters,
m/s, DEGREES, deg/s — Frame.py:8).  Copied, not imported: importing any
``rsoccer_tpu`` module loads JAX.  ``tests/test_torch_frame_render.py``
holds the classes, and the frames built from equal states, equal to the
JAX package's.

The builders read the port's batch-last ``WorldState`` (every leaf ends in
the env batch).  A view of one env costs ONE device-to-host copy of that
env's leaves; degrees are taken on the host in numpy f32, as the JAX
package does, so equal states give frames equal to the bit.  A ``fused``
state is packed: take it through ``BatchedEnv.unpack_state`` first.  Used
by the gymnasium wrappers and the renderer; the hot path never builds one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch


@dataclass
class Ball:
    """Reference Entities/Ball.py:3-10."""

    x: float = None
    y: float = None
    z: float = None
    v_x: float = 0.0
    v_y: float = 0.0
    v_z: float = 0.0


@dataclass
class Robot:
    """Reference Entities/Robot.py:4-23 — state and command in one type."""

    yellow: bool = None
    id: int = None
    x: float = None
    y: float = None
    z: float = None
    theta: float = None  # degrees
    v_x: float = 0.0
    v_y: float = 0.0
    v_theta: float = 0.0  # deg/s
    kick_v_x: float = 0.0
    kick_v_z: float = 0.0
    dribbler: bool = False
    infrared: bool = False
    wheel_speed: bool = False
    v_wheel0: float = 0.0  # rad/s
    v_wheel1: float = 0.0
    v_wheel2: float = 0.0
    v_wheel3: float = 0.0


@dataclass
class Frame:
    """Reference Entities/Frame.py:7-14."""

    ball: Ball = field(default_factory=Ball)
    robots_blue: Dict[int, Robot] = field(default_factory=dict)
    robots_yellow: Dict[int, Robot] = field(default_factory=dict)


def _env_leaves(world, env_index: int) -> dict:
    """Every leaf of env ``env_index`` as numpy f32 (``infrared`` bool),
    through one device-to-host copy."""
    b, rb = world.ball, world.robots
    leaves = {
        "ball": torch.stack([b.x, b.y, b.z, b.v_x, b.v_y, b.v_z])[:, env_index],
        "x": rb.x[:, env_index], "y": rb.y[:, env_index], "theta": rb.theta[:, env_index],
        "v_x": rb.v_x[:, env_index], "v_y": rb.v_y[:, env_index],
        "v_theta": rb.v_theta[:, env_index],
        "infrared": rb.infrared[:, env_index].to(torch.float32),
        "v_wheel": rb.v_wheel[:, :, env_index].reshape(-1),
    }
    flat = torch.cat([v.reshape(-1).to(torch.float32) for v in leaves.values()]).cpu().numpy()
    out, off = {}, 0
    for name, v in leaves.items():
        out[name] = flat[off : off + v.numel()]
        off += v.numel()
    out["infrared"] = out["infrared"] > 0.5
    out["v_wheel"] = out["v_wheel"].reshape(-1, 4)
    return out


def frame_from_batched(world, env_index: int, n_blue: int, n_yellow: int) -> Frame:
    """Degree-based host Frame of env ``env_index`` of a batch-last
    ``WorldState``.

    Equivalent role to FrameVSS/FrameSSL.parse (Entities/Frame.py:18-93),
    reading the struct-of-arrays state instead of a flat float vector.
    """
    h = _env_leaves(world, env_index)
    ball = h["ball"]
    frame = Frame(
        ball=Ball(
            x=float(ball[0]), y=float(ball[1]), z=float(ball[2]),
            v_x=float(ball[3]), v_y=float(ball[4]), v_z=float(ball[5]),
        )
    )
    x, y = h["x"], h["y"]
    theta = np.degrees(h["theta"]) % 360.0
    v_x, v_y = h["v_x"], h["v_y"]
    v_theta = np.degrees(h["v_theta"])
    infrared, v_wheel = h["infrared"], h["v_wheel"]

    def mk(i, yellow, rid):
        return Robot(
            yellow=yellow, id=rid,
            x=float(x[i]), y=float(y[i]), z=0.0, theta=float(theta[i]),
            v_x=float(v_x[i]), v_y=float(v_y[i]), v_theta=float(v_theta[i]),
            infrared=bool(infrared[i]),
            v_wheel0=float(v_wheel[i, 0]), v_wheel1=float(v_wheel[i, 1]),
            v_wheel2=float(v_wheel[i, 2]), v_wheel3=float(v_wheel[i, 3]),
        )

    for i in range(n_blue):
        frame.robots_blue[i] = mk(i, False, i)
    for j in range(n_yellow):
        frame.robots_yellow[j] = mk(n_blue + j, True, j)
    return frame


def frame_from_world(world, n_blue: int, n_yellow: int) -> Frame:
    """Frame of a single env's ``WorldState`` (leaves end in a batch of 1,
    the port's single env)."""
    if world.ball.x.shape[-1] != 1:
        raise ValueError(
            f"frame_from_world reads a batch of 1, got {world.ball.x.shape[-1]} "
            "envs; use frame_from_batched(world, env_index, ...)"
        )
    return frame_from_batched(world, 0, n_blue, n_yellow)
