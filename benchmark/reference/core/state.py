"""World-state containers: NamedTuples of tensors, batch-last.

Same fields and order as ``rsoccer_tpu/core/state.py``.  Every leaf carries
the env batch as its LAST axis: ball fields ``(B,)``, robot fields
``(N, B)``, ``v_wheel`` ``(N, 4, B)`` — the layout the JAX package's vmap
produces, so the two packages compare elementwise and the fused kernel's
packed ``(S, B)`` rows are contiguous slices of it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BallState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor  # center height, m; rest = ball_radius
    v_x: torch.Tensor
    v_y: torch.Tensor
    v_z: torch.Tensor


class RobotsState(NamedTuple):
    """All robots of a world, blues first then yellows. Leaves (N, B)."""

    x: torch.Tensor
    y: torch.Tensor
    theta: torch.Tensor  # radians, wrapped to [-pi, pi)
    v_x: torch.Tensor  # world-frame m/s
    v_y: torch.Tensor
    v_theta: torch.Tensor  # rad/s
    infrared: torch.Tensor  # bool; always False for VSS worlds
    v_wheel: torch.Tensor  # (N, 4, B) achieved wheel speeds, rad/s


class WorldState(NamedTuple):
    ball: BallState
    robots: RobotsState


def make_world(n_robots: int, batch: int = 1, device="cuda", dtype=torch.float32,
               ball_radius: float = 0.0215) -> WorldState:
    """A zero-initialised world of ``batch`` envs with ``n_robots`` robots
    each (``rsoccer_tpu/core/state.py::make_world``, batch-last).  The ball
    rests on the ground: ``z = ball_radius`` (center height)."""
    def zeros(*shape, dt=dtype):
        return torch.zeros((*shape, batch), dtype=dt, device=device)

    rest = torch.full((batch,), ball_radius, dtype=dtype, device=device)
    return WorldState(
        ball=BallState(zeros(), zeros(), rest, zeros(), zeros(), zeros()),
        robots=RobotsState(*(zeros(n_robots) for _ in range(6)),
                           infrared=zeros(n_robots, dt=torch.bool), v_wheel=zeros(n_robots, 4)),
    )


class VSSCommands(NamedTuple):
    """Per-robot VSS wheel-speed targets, rad/s, leaves (N, B)."""

    v_wheel0: torch.Tensor
    v_wheel1: torch.Tensor


class SSLCommands(NamedTuple):
    """Per-robot SSL commands (the reference's 8-slot layout,
    Simulators/rsim.py:128-155): four wheel-speed targets or a local-frame
    velocity target, chosen by ``wheel_speed``, plus kicker and dribbler.
    Leaves (N, B); ``v_wheel`` (N, 4, B)."""

    wheel_speed: torch.Tensor  # bool — True: wheel targets, False: velocity
    v_wheel: torch.Tensor  # rad/s targets (wheel_speed mode)
    v_x: torch.Tensor  # local-frame m/s (velocity mode)
    v_y: torch.Tensor
    v_theta: torch.Tensor  # rad/s
    kick_v_x: torch.Tensor  # m/s along the heading (<= 0: no kick)
    kick_v_z: torch.Tensor  # m/s vertical (chip kick)
    dribbler: torch.Tensor  # bool


def zero_ssl_commands(n_robots: int, batch: int, device) -> SSLCommands:
    zn = torch.zeros((n_robots, batch), device=device)
    off = torch.zeros((n_robots, batch), dtype=torch.bool, device=device)
    return SSLCommands(
        wheel_speed=off,
        v_wheel=torch.zeros((n_robots, 4, batch), device=device),
        v_x=zn, v_y=zn, v_theta=zn, kick_v_x=zn, kick_v_z=zn,
        dribbler=off,
    )


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over (nested) NamedTuples of tensors."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(
            *(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
        )
    return fn(tree, *rest)
