"""The robot-robot contact pass per robot, as the cooperative VSS substep
runs it (``csrc/vss_world.cuh``): robot k, on its own lane, adds the terms
of its partners 0..N-1 in partner order.  Each term is taken in one of two
ways: ``shared`` (the kernels' way) evaluates pair (i, j), i < j, once from
the lower robot's side, and robot k adds it where k = i and subtracts it
where k = j; ``own_side`` evaluates every pair from robot k's side,
``x_k - x_q``.  Written out here in torch, both must equal to the bit in
f32:

- the pair-list pass ``ops/pair_collide.resolve_pair_collisions`` (the
  fused VSS step's form: rsqrt normals, terms added straight into x),
  which evaluates each pair once from the lower robot's side and subtracts
  it from the higher one;
- the dense N x N sums of the plain ``physics/vss`` step
  (``physics/common.resolve_robot_robot``: sqrt, true division, terms
  summed per robot and then added).

This is the invariant the CUDA kernels K1 and K2 rest on: the order is
partner order in all three, and IEEE subtraction and division are
sign-symmetric, so a term from the higher robot's side is the exact
negation of the lower robot's.  Worlds are seeded with numpy and packed so that most pairs
touch.  The batch is a multiple of the CPU's vector width, where torch sums
a (N, N, B) tensor over its middle axis in index order.
"""

import numpy as np
import pytest
import torch

from rsoccer_tpu_torch.ops.pair_collide import resolve_pair_collisions
from rsoccer_tpu_torch.physics.common import resolve_robot_robot

B = 256
R_RBT = 0.0375  # VSS robot radius (core/field.py)
RESTITUTION = 0.1  # PhysicsConfig.rest_robot_robot
_EPS = 1e-8


def packed_world(n: int, seed: int):
    """(x, y, vx, vy), each (n, B) f32: robots in a box 2.4 radii wide, so
    most pairs overlap; velocities both closing and separating."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.2 * R_RBT, 1.2 * R_RBT, size=(2, n, B))
    vel = rng.uniform(-1.0, 1.0, size=(2, n, B))
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (*pos, *vel))


def touching_share(x, y) -> float:
    n = x.shape[0]
    d = torch.sqrt((x[:, None] - x[None]) ** 2 + (y[:, None] - y[None]) ** 2)
    iu = torch.triu_indices(n, n, 1)
    return float((d[iu[0], iu[1]] < 2 * R_RBT).float().mean())


def partners(n: int, k: int):
    return [q for q in range(n) if q != k]


def rsqrt_term(a, b, r_rbt: float, restitution: float):
    """(x, y, vx, vy) term robot a adds for pair (a, b): the fused step's
    form (rsqrt normals)."""
    dx = a[0] - b[0]
    dy = a[1] - b[1]
    d2 = torch.clamp_min(dx * dx + dy * dy, _EPS * _EPS)
    inv_d = torch.rsqrt(d2)
    overlap = 2.0 * r_rbt - d2 * inv_d
    colliding = overlap > 0.0
    f = torch.where(colliding, 0.5 * overlap, 0.0) * inv_d
    vn = (a[2] - b[2]) * dx + (a[3] - b[3]) * dy
    g = torch.where(colliding & (vn < 0.0), -(1.0 + restitution) * 0.5 * vn, 0.0) * (inv_d * inv_d)
    return f * dx, f * dy, g * dx, g * dy


def exact_term(a, b, radius: float, restitution: float):
    """The same for the physics step's form (sqrt, true division)."""
    dx = a[0] - b[0]
    dy = a[1] - b[1]
    d = torch.sqrt(torch.clamp_min(dx * dx + dy * dy, _EPS * _EPS))
    overlap = 2.0 * radius - d
    colliding = overlap > 0.0
    nx = dx / torch.clamp_min(d, _EPS)
    ny = dy / torch.clamp_min(d, _EPS)
    push = torch.where(colliding, 0.5 * overlap, 0.0)
    vn = (a[2] - b[2]) * nx + (a[3] - b[3]) * ny
    j = torch.where(colliding & (vn < 0.0), -(1.0 + restitution) * 0.5 * vn, 0.0)
    return push * nx, push * ny, j * nx, j * ny


def per_robot_pass(world, term, form: str, sum_then_add: bool, *consts):
    """Robot by robot, partner order; the terms from ``term`` taken the
    ``form`` way; added straight in, or summed and then added."""
    n = world[0].shape[0]
    out = []
    for k in range(n):
        own = [v[k] for v in world]
        acc = [torch.zeros_like(v) for v in own] if sum_then_add else list(own)
        for q in partners(n, k):
            other = [v[q] for v in world]
            if form == "own_side":
                t = term(own, other, *consts)
            elif k < q:
                t = term(own, other, *consts)
            else:
                t = tuple(-v for v in term(other, own, *consts))
            acc = [a + v for a, v in zip(acc, t)]
        out.append([o + a for o, a in zip(own, acc)] if sum_then_add else acc)
    return tuple(torch.stack([robot[c] for robot in out]) for c in range(4))


def assert_bit_equal(got, want):
    for name, g, w in zip(("x", "y", "vx", "vy"), got, want):
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(g, w), f"{name}: {int((g != w).sum())} of {g.numel()} differ"


FORMS = ["shared", "own_side"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 3, 6, 10])
def test_partner_order_matches_pair_list(n, seed, form):
    world = packed_world(n, seed)
    assert touching_share(world[0], world[1]) > 0.5
    assert_bit_equal(per_robot_pass(world, rsqrt_term, form, False, R_RBT, RESTITUTION),
                     resolve_pair_collisions(*world, R_RBT, RESTITUTION))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 3, 6, 10])
def test_partner_order_matches_dense_sums(n, seed, form):
    world = packed_world(n, seed)
    assert touching_share(world[0], world[1]) > 0.5
    assert_bit_equal(per_robot_pass(world, exact_term, form, True, R_RBT, RESTITUTION),
                     resolve_robot_robot(*world, R_RBT, RESTITUTION))


def test_the_pair_terms_do_move_the_robots():
    """The packed worlds exercise both terms: positions and velocities
    change on most robots."""
    world = packed_world(6, 0)
    got = per_robot_pass(world, exact_term, "shared", True, R_RBT, RESTITUTION)
    for g, w in zip(got, world):
        assert float((g != w).float().mean()) > 0.5
