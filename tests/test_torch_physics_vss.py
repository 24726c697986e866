"""The port's VSS physics vs the JAX package's (vmapped XLA path) and the
C++ oracle, on crowded random worlds: robots overlapping, the ball in the
goal pockets, in the air and against the walls."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsoccer_tpu.core import state as jstate
from rsoccer_tpu.core.field import vss_field as j_vss_field
from rsoccer_tpu.ops.pair_collide import resolve_pair_collisions as j_pairs
from rsoccer_tpu.physics.config import VSS_PHYSICS as J_PHYS
from rsoccer_tpu.physics.vss import make_vss_step as j_make_step
from rsoccer_tpu_torch.core import state as tstate
from rsoccer_tpu_torch.core.field import vss_field
from rsoccer_tpu_torch.ops.pair_collide import resolve_pair_collisions
from rsoccer_tpu_torch.physics.config import VSS_PHYSICS
from rsoccer_tpu_torch.physics.vss import make_vss_step

torch.set_num_threads(1)

DT = 0.025
ATOL = 5e-5
FIELD = vss_field(0)


def crowded_worlds(rng, b, n=6, scene="crowded"):
    """Batch-last numpy world (ball (6, B), robots (6, N, B)) + commands."""
    f = FIELD
    ball = np.zeros((6, b), np.float32)
    robots = np.zeros((6, n, b), np.float32)
    if scene == "crowded":  # everyone in a 25 cm box around the ball
        cx, cy = rng.uniform(-0.4, 0.4, b), rng.uniform(-0.3, 0.3, b)
        robots[0] = cx + rng.uniform(-0.12, 0.12, (n, b))
        robots[1] = cy + rng.uniform(-0.12, 0.12, (n, b))
        ball[0], ball[1] = cx, cy
        ball[2] = f.ball_radius
    elif scene == "pockets":  # ball past the end lines, some in the air
        side = rng.choice([-1.0, 1.0], b)
        ball[0] = side * rng.uniform(0.70, 0.84, b)
        ball[1] = rng.uniform(-0.25, 0.25, b)
        air = rng.uniform(size=b) < 0.5
        ball[2] = f.ball_radius + np.where(air, rng.uniform(0.0, 0.3, b), 0.0)
        ball[5] = np.where(air, rng.uniform(-1.0, 2.0, b), 0.0)
        robots[0] = side * rng.uniform(0.55, 0.72, (n, b))
        robots[1] = rng.uniform(-0.3, 0.3, (n, b))
    else:  # walls: ball and robots pressed against the side and end walls
        ball[0] = rng.uniform(-0.74, 0.74, b)
        ball[1] = rng.choice([-1.0, 1.0], b) * rng.uniform(0.6, 0.66, b)
        ball[2] = f.ball_radius
        robots[0] = rng.choice([-1.0, 1.0], (n, b)) * rng.uniform(0.6, 0.76, (n, b))
        robots[1] = rng.uniform(-0.66, 0.66, (n, b))
    ball[3:5] = rng.uniform(-1.5, 1.5, (2, b))
    robots[2] = rng.uniform(-np.pi, np.pi, (n, b))
    robots[3:5] = rng.uniform(-0.8, 0.8, (2, n, b))
    robots[5] = rng.uniform(-8, 8, (n, b))
    cmds = rng.uniform(-50, 50, (2, n, b)).astype(np.float32)
    return ball, robots, cmds


def _world(mod, xp, ball, robots):
    n, b = robots.shape[1:]
    return mod.WorldState(
        ball=mod.BallState(*(xp(ball[i]) for i in range(6))),
        robots=mod.RobotsState(
            *(xp(robots[i]) for i in range(6)),
            infrared=xp(np.zeros((n, b), bool)),
            v_wheel=xp(np.zeros((n, 4, b), np.float32)),
        ),
    )


def _assert_worlds_close(got, want, atol):
    names = ["ball." + k for k in jstate.BallState._fields] + [
        "robots." + k for k in jstate.RobotsState._fields
    ]
    for name, g, w in zip(names, jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        if name == "robots.theta":  # same angle across the +-pi wrap
            g = np.remainder(g - w + np.pi, 2 * np.pi) - np.pi
            w = np.zeros_like(w)
        np.testing.assert_allclose(g, w, atol=atol, err_msg=name)


@pytest.mark.parametrize("scene", ["crowded", "pockets", "walls"])
def test_vss_step_matches_jax(scene):
    rng = np.random.default_rng({"crowded": 0, "pockets": 1, "walls": 2}[scene])
    ball, robots, cmds = crowded_worlds(rng, 64, scene=scene)
    j_step = jax.vmap(
        j_make_step(j_vss_field(0), J_PHYS, DT), in_axes=-1, out_axes=-1
    )
    t_step = make_vss_step(FIELD, VSS_PHYSICS, DT)
    jw = _world(jstate, jnp.asarray, ball, robots)
    tw = _world(tstate, torch.from_numpy, ball, robots)
    for t in range(3):  # a few control steps of the same commands
        jw = j_step(jw, jstate.VSSCommands(jnp.asarray(cmds[0]), jnp.asarray(cmds[1])))
        tw = t_step(tw, tstate.VSSCommands(torch.from_numpy(cmds[0]), torch.from_numpy(cmds[1])))
        _assert_worlds_close(
            jax.tree.map(lambda x: x.numpy(), tw, is_leaf=torch.is_tensor), jw, ATOL
        )


@pytest.mark.parametrize("n", [1, 2, 6, 10])
def test_pair_collide_matches_jax(n):
    rng = np.random.default_rng(n)
    b = 64
    x = rng.uniform(-0.1, 0.1, (n, b)).astype(np.float32)  # heavily overlapping
    y = rng.uniform(-0.1, 0.1, (n, b)).astype(np.float32)
    vx = rng.uniform(-1, 1, (n, b)).astype(np.float32)
    vy = rng.uniform(-1, 1, (n, b)).astype(np.float32)
    r, rest = FIELD.rbt_radius, VSS_PHYSICS.rest_robot_robot
    want = j_pairs(*(jnp.asarray(a) for a in (x, y, vx, vy)), r, rest)
    got = resolve_pair_collisions(*(torch.from_numpy(a) for a in (x, y, vx, vy)), r, rest)
    for g, w, name in zip(got, want, ("x", "y", "vx", "vy")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_vss_step_matches_native_oracle():
    """Per step, to 2e-4, against csrc/vss_physics.cpp — the independent
    C++ statement of the same physics (tests/test_native_oracle.py)."""
    from rsoccer_tpu.ops.native import vss_step_native

    t_step = make_vss_step(FIELD, VSS_PHYSICS, DT)
    rng = np.random.default_rng(0)
    for trial in range(20):
        ball, robots, cmds = crowded_worlds(rng, 1, scene=("crowded", "pockets", "walls")[trial % 3])
        tw = t_step(
            _world(tstate, torch.from_numpy, ball, robots),
            tstate.VSSCommands(torch.from_numpy(cmds[0]), torch.from_numpy(cmds[1])),
        )
        b_c = np.ascontiguousarray(ball[:, 0])
        r_c = np.ascontiguousarray(robots[:, :, 0].T)  # (N, 6)
        vss_step_native(j_vss_field(0), J_PHYS, DT, b_c, r_c,
                        np.ascontiguousarray(cmds[:, :, 0].T))
        got_b = np.array([getattr(tw.ball, k)[0].item() for k in tstate.BallState._fields])
        np.testing.assert_allclose(got_b, b_c, atol=2e-4, err_msg=f"trial {trial} ball")
        got_r = np.stack(
            [getattr(tw.robots, k)[:, 0].numpy() for k in tstate.RobotsState._fields[:6]], -1
        )
        dth = np.remainder(got_r[:, 2] - r_c[:, 2] + np.pi, 2 * np.pi) - np.pi
        got_r[:, 2], r_c[:, 2] = dth, 0.0
        np.testing.assert_allclose(got_r, r_c, atol=2e-4, err_msg=f"trial {trial} robots")
