"""Shared branch-free physics: circle collisions and wall geometry.

Port of ``rsoccer_tpu/physics/common.py`` onto batch-last tensors: robot
leaves are ``(N, B)``, ball leaves ``(B,)``.  The robot-robot contact keeps
the reference's dense N x N form (``(N, N, B)`` pair tensors); the fused
kernel uses the pair-list form of ``ops/pair_collide.py`` instead.

Clamps go through :func:`clip` and :func:`maximum` (``torch.minimum`` /
``torch.maximum``), not ``torch.clamp``: the same bits forward, and at a
tie the gradient splits evenly between the two sides as ``jnp.clip`` and
``jnp.maximum``'s do (``torch.clamp`` passes all of it to the input).  A
robot pinned at a wall sits exactly on its bound, and
``tools/calibrate.py`` differentiates through here.  Coefficients may be
floats or 0-d tensors.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _tensor(v, like):
    """A float as a 0-d tensor of ``like``'s dtype (rounded as
    ``torch.clamp`` rounds a float bound); a tensor as it is."""
    return v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=like.dtype)


def maximum(x, lo):
    """``jnp.maximum(x, lo)``: ``lo`` a float or a tensor."""
    return torch.maximum(x, _tensor(lo, x))


def clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: ``min(max(x, lo), hi)``."""
    return torch.minimum(maximum(x, lo), _tensor(hi, x))


def resolve_robot_robot(x, y, v_x, v_y, radius: float, restitution: float):
    """All-pairs disc-disc collision among N robots (equal masses).

    Args are (N, B); returns corrected (x, y, v_x, v_y).
    """
    dx = x[:, None] - x[None, :]  # (N, N, B)
    dy = y[:, None] - y[None, :]
    d2 = dx * dx + dy * dy
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)[:, :, None]
    d = torch.sqrt(torch.where(eye, 1.0, maximum(d2, _EPS * _EPS)))
    overlap = torch.where(eye, 0.0, 2.0 * radius - d)
    colliding = overlap > 0.0

    nx = dx / maximum(d, _EPS)
    ny = dy / maximum(d, _EPS)

    # positional separation: each robot moves half the overlap away
    push = torch.where(colliding, 0.5 * overlap, 0.0)
    x = x + torch.sum(push * nx, dim=1)
    y = y + torch.sum(push * ny, dim=1)

    # velocity impulse: reflect the closing component of relative velocity
    rvx = v_x[:, None] - v_x[None, :]
    rvy = v_y[:, None] - v_y[None, :]
    vn = rvx * nx + rvy * ny  # negative when closing
    j = torch.where(
        colliding & (vn < 0.0), -(1.0 + restitution) * 0.5 * vn, 0.0
    )
    v_x = v_x + torch.sum(j * nx, dim=1)
    v_y = v_y + torch.sum(j * ny, dim=1)
    return x, y, v_x, v_y


def resolve_ball_robots(
    bx, by, bvx, bvy, rx, ry, rvx, rvy,
    robot_radius: float, ball_radius: float, restitution: float,
    active=None,
):
    """Ball (B,) vs N robot discs (N, B).  The ball takes the full
    correction; robots are unaffected.  ``active`` (B,) bool: when False
    every contact is ignored (ball above the robots)."""
    dx = bx - rx
    dy = by - ry
    d2 = dx * dx + dy * dy
    d = torch.sqrt(maximum(d2, _EPS * _EPS))
    overlap = (robot_radius + ball_radius) - d
    colliding = overlap > 0.0
    if active is not None:
        colliding = colliding & active

    nx = dx / maximum(d, _EPS)
    ny = dy / maximum(d, _EPS)

    bx = bx + torch.sum(torch.where(colliding, overlap, 0.0) * nx, dim=0)
    by = by + torch.sum(torch.where(colliding, overlap, 0.0) * ny, dim=0)

    rel_vx = bvx - rvx
    rel_vy = bvy - rvy
    vn = rel_vx * nx + rel_vy * ny
    j = torch.where(colliding & (vn < 0.0), -(1.0 + restitution) * vn, 0.0)
    bvx = bvx + torch.sum(j * nx, dim=0)
    bvy = bvy + torch.sum(j * ny, dim=0)
    return bx, by, bvx, bvy


def reflect_ball_walls_vss(
    bx, by, bvx, bvy, half_len: float, half_wid: float, goal_half_wid: float,
    goal_depth: float, ball_radius: float, restitution: float,
):
    """VSS walled field with goal pockets of depth ``goal_depth`` behind
    the end walls for |y| < goal_half_wid."""
    r = ball_radius
    in_mouth = torch.abs(by) < goal_half_wid

    x_wall = torch.where(in_mouth, half_len + goal_depth, half_len) - r
    hit_x = (torch.abs(bx) - x_wall) > 0.0
    sx = torch.sign(bx)
    bx = torch.where(hit_x, sx * x_wall, bx)
    bvx = torch.where(hit_x & (bvx * sx > 0.0), -restitution * bvx, bvx)

    in_pocket = torch.abs(bx) > half_len
    y_wall = torch.where(in_pocket, goal_half_wid, half_wid) - r
    hit_y = (torch.abs(by) - y_wall) > 0.0
    sy = torch.sign(by)
    by = torch.where(hit_y, sy * y_wall, by)
    bvy = torch.where(hit_y & (bvy * sy > 0.0), -restitution * bvy, bvy)
    return bx, by, bvx, bvy


def clamp_robots_walls_vss(
    x, y, v_x, v_y, half_len: float, half_wid: float, radius: float
):
    """Robots clamp dead against the VSS walls (no bounce, no goal entry)."""
    xl = half_len - radius
    yl = half_wid - radius
    hit_x = torch.abs(x) > xl
    hit_y = torch.abs(y) > yl
    v_x = torch.where(hit_x & (v_x * torch.sign(x) > 0.0), 0.0, v_x)
    v_y = torch.where(hit_y & (v_y * torch.sign(y) > 0.0), 0.0, v_y)
    x = clip(x, -xl, xl)
    y = clip(y, -yl, yl)
    return x, y, v_x, v_y


def apply_ball_friction(bvx, bvy, decel: float, dt: float):
    """Constant-deceleration rolling friction toward rest."""
    speed = torch.sqrt(bvx * bvx + bvy * bvy + _EPS * _EPS)
    scale = maximum(1.0 - decel * dt / speed, 0.0)
    return bvx * scale, bvy * scale


def step_ball_vertical(
    z, v_z, ball_radius: float, gravity: float, restitution: float,
    min_bounce_v: float, dt: float,
):
    """One vertical substep: gravity, floor bounce, bounce settling."""
    v_z = v_z - gravity * dt
    z = z + v_z * dt
    hit = z < ball_radius
    v_z = torch.where(hit & (v_z < 0.0), -restitution * v_z, v_z)
    v_z = torch.where(hit & (v_z < min_bounce_v), 0.0, v_z)
    z = torch.where(hit, ball_radius, z)
    return z, v_z


def ball_on_ground(z, ball_radius: float):
    return z <= ball_radius + 1e-4


def wrap_angle(theta):
    """Wrap to [-pi, pi).  ``torch.remainder`` floor-mods like ``jnp.mod``
    (the result takes the divisor's sign)."""
    return torch.remainder(theta + math.pi, 2.0 * math.pi) - math.pi
