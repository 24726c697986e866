"""The cooperative SSL world step's orders (``csrc/ssl_world.cuh``, the
world step of the fused StaticDefenders and Dribbling group kernels), held
bit-equal in torch, signs of zero included, on packed SSL worlds to the
one-thread step's (``csrc/ssl_body.cuh``):

- robot-robot contacts: robot k, on its own lane, evaluates its contact
  with every partner 0..N-1 from its own side and adds the terms in partner
  order, a zero coordinate difference taken as -0 where robot k is the
  higher robot of the pair (its own slot adds -0) — equal to the pair-list
  pass ``ops/pair_collide.resolve_pair_collisions`` that the one-thread
  step runs, which evaluates each pair once from the lower robot's side and
  subtracts it from the higher one;
- ball-robot contacts: robot k posts its term (robot 0's kicker face
  absorbing with ``rest_dribbler`` while it dribbles) and every lane sums
  the posted terms of the robots that can touch the ball in robot order —
  equal to the one-thread loop that adds every robot's term as it computes
  it.

Worlds are seeded with numpy, at the SSL robot radius and restitutions of
``core/field.py`` and ``physics/config.py``, for N = 5 (SSLDribbling-v0)
and N = 7 (SSLStaticDefenders-v0); the robots are packed so that most
pairs touch, and the ball sits among them.  A ``course`` world puts the
robots on one line at exactly y = 0, as SSLDribbling-v0's reset does, where
the signed zero matters.
"""

import numpy as np
import pytest
import torch

from rsoccer_tpu_torch.core.field import SSL_FIELDS
from rsoccer_tpu_torch.ops.pair_collide import resolve_pair_collisions
from rsoccer_tpu_torch.physics.config import SSL_PHYSICS

B = 256
FIELD = SSL_FIELDS[2]  # the field of SSLStaticDefenders-v0 and SSLDribbling-v0
R_RBT = FIELD.rbt_radius
R_BALL = FIELD.ball_radius
REST_RR = SSL_PHYSICS.rest_robot_robot
BALL_GAIN = -(1.0 + SSL_PHYSICS.rest_ball_robot)
DRIB_GAIN = -(1.0 + SSL_PHYSICS.rest_dribbler)
RBT_HEIGHT = SSL_PHYSICS.rbt_height
N_ROBOTS = [5, 7]


def packed_world(n: int, seed: int):
    """(x, y, vx, vy), each (n, B) f32: robots in a box 2.4 radii wide;
    velocities both closing and separating."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.2 * R_RBT, 1.2 * R_RBT, size=(2, n, B))
    vel = rng.uniform(-1.0, 1.0, size=(2, n, B))
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (*pos, *vel))


def course_world(n: int, seed: int):
    """Robots on the x axis at exactly y = 0, 1.6 radii apart (every
    neighbour pair touching), some velocities exactly 0 (+0 or -0)."""
    rng = np.random.default_rng(200 + seed)
    x = (np.arange(n) * 1.6 * R_RBT)[:, None] + rng.uniform(-0.1, 0.1, size=(n, B)) * R_RBT
    y = np.zeros((n, B))
    vx = np.where(rng.uniform(size=(n, B)) < 0.5, rng.uniform(-1.0, 1.0, size=(n, B)), 0.0)
    vy = np.where(rng.uniform(size=(n, B)) < 0.5, -0.0, 0.0)
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (x, y, vx, vy))


WORLDS = {"packed": packed_world, "course": course_world}


def own_side_term(a, b, higher: bool):
    """ssl_world.cuh's ssl_pair_term: the terms robot a adds for its contact
    with robot b, from a's side; from the higher robot's side a zero
    coordinate difference is -0."""
    dx = a[0] - b[0]
    dy = a[1] - b[1]
    if higher:
        neg_zero = torch.tensor(-0.0, dtype=torch.float32)
        dx = torch.where(dx == 0.0, neg_zero, dx)
        dy = torch.where(dy == 0.0, neg_zero, dy)
    d2 = torch.clamp_min(dx * dx + dy * dy, 1e-16)
    inv_d = torch.rsqrt(d2)
    overlap = 2.0 * R_RBT - d2 * inv_d
    colliding = overlap > 0.0
    f = torch.where(colliding, 0.5 * overlap, 0.0) * inv_d
    vn = (a[2] - b[2]) * dx + (a[3] - b[3]) * dy
    g = torch.where(colliding & (vn < 0.0), -(1.0 + REST_RR) * 0.5 * vn, 0.0) * (inv_d * inv_d)
    return f * dx, f * dy, g * dx, g * dy


def own_side_pass(world, zero_rule: bool = True):
    """ssl_world.cuh's pass: robot k adds, in partner order 0..N-1, its own
    side's terms; its own slot adds -0."""
    n = world[0].shape[0]
    out = []
    for k in range(n):
        own = [v[k] for v in world]
        acc = list(own)
        for q in range(n):
            t = own_side_term(own, [v[q] for v in world], zero_rule and q < k)
            if q == k:
                t = tuple(torch.full_like(v, -0.0) for v in t)
            acc = [a + v for a, v in zip(acc, t)]
        out.append(acc)
    return tuple(torch.stack([robot[c] for robot in out]) for c in range(4))


def assert_same_bits(got, want):
    for name, g, w in zip(("x", "y", "vx", "vy"), got, want):
        assert g.dtype == w.dtype == torch.float32
        same = g.view(torch.int32) == w.view(torch.int32)
        assert bool(same.all()), f"{name}: {int((~same).sum())} of {g.numel()} differ"


def ball_among(seed: int):
    """A ball (x, y, z, vx, vy) among the packed robots: most lanes on the
    ground, some above the robots' top plate; robot 0 dribbles on half the
    lanes, and its face test passes where the ball is ahead of it."""
    rng = np.random.default_rng(100 + seed)
    x, y = rng.uniform(-1.5 * R_RBT, 1.5 * R_RBT, size=(2, B))
    z = np.where(rng.uniform(size=B) < 0.8, R_BALL, R_BALL + 1.5 * RBT_HEIGHT)
    vx, vy = rng.uniform(-2.0, 2.0, size=(2, B))
    face = rng.uniform(size=B) < 0.5  # stands for robot 0's kicker-face test
    drib0 = rng.uniform(size=B) < 0.5
    as_t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    return (as_t(x), as_t(y), as_t(z), as_t(vx), as_t(vy)), torch.from_numpy(face & drib0)


def contact_term(ball, robot, absorb):
    """Robot ``robot``'s ball-contact term (push x, push y, impulse x,
    impulse y): ssl_body.cuh's expressions, rsqrt normals."""
    bx, by, bz, bvx, bvy = ball
    rx, ry, rvx, rvy = robot
    below_top = (bz - R_BALL) < RBT_HEIGHT
    dx = bx - rx
    dy = by - ry
    d2 = torch.clamp_min(dx * dx + dy * dy, 1e-16)
    inv_d = torch.rsqrt(d2)
    overlap = (R_RBT + R_BALL) - d2 * inv_d
    col = (overlap > 0.0) & below_top
    nx, ny = dx * inv_d, dy * inv_d
    vn = (bvx - rvx) * nx + (bvy - rvy) * ny
    gain = torch.where(absorb, torch.tensor(DRIB_GAIN, dtype=torch.float32),
                       torch.tensor(BALL_GAIN, dtype=torch.float32))
    j = torch.where(col & (vn < 0.0), gain * vn, 0.0)
    push = torch.where(col, overlap, 0.0)
    return push * nx, push * ny, j * nx, j * ny


def one_thread_contacts(ball, world, absorb0):
    """ssl_body.cuh: one loop over the robots, each term added as it is
    computed; then the ball moves by the sums."""
    n = world[0].shape[0]
    acc = [torch.zeros(B, dtype=torch.float32) for _ in range(4)]
    for r in range(n):
        absorb = absorb0 if r == 0 else torch.zeros(B, dtype=torch.bool)
        t = contact_term(ball, [v[r] for v in world], absorb)
        acc = [a + v for a, v in zip(acc, t)]
    bx, by, _, bvx, bvy = ball
    return bx + acc[0], by + acc[1], bvx + acc[2], bvy + acc[3]


def lane_contacts(ball, world, absorb0):
    """ssl_world.cuh: every robot's term posted first (robot 0 absorbing on
    its own lane), then the posted terms of the robots that can touch the
    ball (within reach times 1 + 1e-4, below its top plate) summed in robot
    order from zero; every other robot's term is a zero, which cannot change
    a sum started from +0."""
    n = world[0].shape[0]
    posted = [contact_term(ball, [v[k] for v in world], absorb0 & (k == 0)) for k in range(n)]
    below_top = (ball[2] - R_BALL) < RBT_HEIGHT
    reach = torch.tensor((R_RBT + R_BALL) * 1.0001, dtype=torch.float32)
    sums = []
    for c in range(4):
        s = torch.zeros(B, dtype=torch.float32)
        for k in range(n):
            dx, dy = ball[0] - world[0][k], ball[1] - world[1][k]
            d2 = torch.clamp_min(dx * dx + dy * dy, 1e-16)
            may_touch = below_top & ~(d2 > reach * reach)
            s = torch.where(may_touch, s + posted[k][c], s)
        sums.append(s)
    bx, by, _, bvx, bvy = ball
    return bx + sums[0], by + sums[1], bvx + sums[2], bvy + sums[3]


def touching_share(x, y) -> float:
    n = x.shape[0]
    d = torch.sqrt((x[:, None] - x[None]) ** 2 + (y[:, None] - y[None]) ** 2)
    iu = torch.triu_indices(n, n, 1)
    return float((d[iu[0], iu[1]] < 2 * R_RBT).float().mean())


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", N_ROBOTS)
def test_ssl_own_side_pass_matches_pair_list(n, seed, world):
    w = WORLDS[world](n, seed)
    assert touching_share(w[0], w[1]) > (0.5 if world == "packed" else 0.2)
    assert_same_bits(own_side_pass(w), resolve_pair_collisions(*w, R_RBT, REST_RR))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", N_ROBOTS)
def test_ssl_contact_sums_in_robot_order(n, seed):
    world = packed_world(n, seed)
    ball, absorb0 = ball_among(seed)
    assert_same_bits(lane_contacts(ball, world, absorb0), one_thread_contacts(ball, world, absorb0))


def test_the_zero_rule_is_needed_on_the_course():
    """Without the -0 rule the own-side pass leaves +0 where the pair list
    leaves -0 (robots at exactly y = 0): the course world tells them apart,
    and value for value they agree."""
    w = course_world(5, 0)
    got = own_side_pass(w, zero_rule=False)
    want = resolve_pair_collisions(*w, R_RBT, REST_RR)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert any(bool((g.view(torch.int32) != v.view(torch.int32)).any()) for g, v in zip(got, want))


@pytest.mark.parametrize("n", N_ROBOTS)
def test_the_ssl_worlds_exercise_the_terms(n):
    """Most robots move under the pair terms, the ball is pushed on most
    lanes where it is low, and the dribbler's gain decides some impulses."""
    world = packed_world(n, 0)
    got = own_side_pass(world)
    for g, w in zip(got, world):
        assert float((g != w).float().mean()) > 0.5
    ball, absorb0 = ball_among(0)
    bx, by, bvx, bvy = lane_contacts(ball, world, absorb0)
    low = ball[2] - R_BALL < RBT_HEIGHT
    assert float((bx != ball[0])[low].float().mean()) > 0.5
    assert not bool((bx != ball[0])[~low].any())
    plain_gain = lane_contacts(ball, world, torch.zeros(B, dtype=torch.bool))
    assert bool((plain_gain[2] != bvx)[absorb0].any())
