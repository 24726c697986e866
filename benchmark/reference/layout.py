"""The fused step's packed state, ``(S, B)`` float32 rows, read back into
the reference's structured state.

A frozen copy of the row layout of ``rsoccer_tpu_torch``'s
``pack_vss_state`` / ``unpack_vss_state`` and ``pack_sd_state`` /
``unpack_sd_state``, so that what the program hands out is read by the
benchmark's own code.  Rows, top down:

- both: ball x, y, z, v_x, v_y, v_z (6); then per robot-major block of N
  rows each x, y, theta, v_x, v_y, v_theta (6N); then the step count (1);
- VSS-v0: OU state, wheel 0 of every robot then wheel 1 (2N), the ball
  potential, whether it is set (2), the shaping sums (6): 63 rows at 3v3;
- SSLStaticDefenders-v0: the shaping sums (8): 57 rows at 1 v 6.

The rows hold no wheel speeds and no infrared flags: they are worked out
again from the body state, as the program's unpacking does.
"""

from __future__ import annotations

import torch

from benchmark.reference.core.state import BallState, RobotsState, WorldState
from benchmark.reference.envs.ssl_static_defenders import SDState, SSLStaticDefendersEnv
from benchmark.reference.envs.vss import _SHAPING_KEYS as VSS_SHAPING
from benchmark.reference.envs.vss import VSSEnv, VSSState
from benchmark.reference.physics import ssl as ssl_physics
from benchmark.reference.physics import vss as vss_physics
from benchmark.reference.physics.config import SSL_PHYSICS


def rows(env) -> int:
    """The packed state's row count for ``env``."""
    head = 6 + 6 * env.n_robots + 1
    if isinstance(env, VSSEnv):
        return head + 2 * env.n_robots + 2 + len(VSS_SHAPING)
    if isinstance(env, SSLStaticDefendersEnv):
        return head + 8
    raise NotImplementedError(type(env).__name__)


def unpack(env, arr: torch.Tensor):
    """``(S, B)`` rows -> the reference's state for ``env``."""
    if arr.shape[0] != rows(env):
        raise ValueError(f"{arr.shape[0]} packed rows, the layout of {type(env).__name__} has {rows(env)}")
    n = env.n_robots
    x, y, theta, vx, vy, vth = arr[6:6 + 6 * n].reshape(6, n, -1)
    ball = BallState(*arr[0:6])
    o = 6 + 6 * n
    steps = arr[o].to(torch.int32)
    o += 1
    if isinstance(env, VSSEnv):
        robots = RobotsState(
            x=x, y=y, theta=theta, v_x=vx, v_y=vy, v_theta=vth,
            infrared=torch.zeros_like(x, dtype=torch.bool),
            v_wheel=vss_physics.achieved_wheel_speeds(vx, vy, theta, vth, env.field.rbt_wheel_radius),
        )
        ou = torch.stack([arr[o:o + n], arr[o + n:o + 2 * n]], dim=1)
        o += 2 * n
        return VSSState(world=WorldState(ball=ball, robots=robots), steps=steps, ou_x=ou,
                        ball_potential=arr[o], has_potential=arr[o + 1] > 0.5, shaping=arr[o + 2:])
    f = env.field
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    infrared = ssl_physics.make_face_zone(f, SSL_PHYSICS)(x, y, cos_t, sin_t, arr[0], arr[1], arr[2])
    robots = RobotsState(
        x=x, y=y, theta=theta, v_x=vx, v_y=vy, v_theta=vth, infrared=infrared,
        v_wheel=ssl_physics.achieved_wheel_speeds(vx, vy, cos_t, sin_t, vth,
                                                  ssl_physics.wheel_jacobian(f), f.rbt_wheel_radius),
    )
    return SDState(world=WorldState(ball=ball, robots=robots), steps=steps, shaping=arr[o:])
