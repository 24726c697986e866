"""The port's SSL physics vs the JAX package's (vmapped XLA path) and the
C++ oracle, on random worlds: velocity and wheel-speed commands, kicks and
chip kicks with the ball on the kicker face, and a dribbler holding the
ball in its pull zone."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsoccer_tpu.core import state as jstate
from rsoccer_tpu.core.field import ssl_field as j_ssl_field
from rsoccer_tpu.physics.config import SSL_PHYSICS as J_PHYS
from rsoccer_tpu.physics.ssl import make_ssl_step as j_make_step
from rsoccer_tpu.physics.ssl import wheel_jacobian as j_wheel_jacobian
from rsoccer_tpu_torch.core import state as tstate
from rsoccer_tpu_torch.core.field import ssl_field
from rsoccer_tpu_torch.physics.config import SSL_PHYSICS
from rsoccer_tpu_torch.physics.ssl import make_ssl_step, wheel_jacobian

torch.set_num_threads(1)

DT = 0.025
ATOL = 5e-5
FIELD = ssl_field(2)
SCENES = ["velocity", "wheels", "kick", "dribble"]
BALL_ON_FACE = {"kick": (0.100, 0.112), "dribble": (0.113, 0.140)}  # along the heading


def random_worlds(rng, b, scene, n=7):
    """Batch-last numpy world (ball (6, B), robots (6, N, B)) and commands
    (the native oracle's (11, N, B) slots: wheel_speed, vw0..3, vx, vy,
    vtheta, kick_v_x, kick_v_z, dribbler)."""
    f = FIELD
    robots = np.zeros((6, n, b), np.float32)
    robots[0] = rng.uniform(-1.0, 1.0, (n, b))
    robots[1] = rng.uniform(-0.8, 0.8, (n, b))
    robots[2] = rng.uniform(-np.pi, np.pi, (n, b))
    robots[3:5] = rng.uniform(-1, 1, (2, n, b))
    robots[5] = rng.uniform(-6, 6, (n, b))
    ball = np.zeros((6, b), np.float32)
    ball[0], ball[1] = rng.uniform(-1.0, 1.0, b), rng.uniform(-0.8, 0.8, b)
    ball[2] = f.ball_radius
    ball[3:5] = rng.uniform(-2, 2, (2, b))
    cmd = np.zeros((11, n, b), np.float32)
    cmd[0] = scene == "wheels"
    cmd[1:5] = rng.uniform(-60, 60, (4, n, b))
    cmd[5:7] = rng.uniform(-2, 2, (2, n, b))
    cmd[7] = rng.uniform(-8, 8, (n, b))
    if scene in BALL_ON_FACE:  # the ball on robot 0's kicker face
        lo, hi = BALL_ON_FACE[scene]
        lx, ly = rng.uniform(lo, hi, b), rng.uniform(-0.03, 0.03, b)
        c, s = np.cos(robots[2, 0]), np.sin(robots[2, 0])
        ball[0] = robots[0, 0] + lx * c - ly * s
        ball[1] = robots[1, 0] + lx * s + ly * c
        ball[3:5] = robots[3:5, 0] + rng.uniform(-0.3, 0.3, (2, b))
        robots[5, 0] = rng.uniform(-1, 1, b)
        cmd[7, 0] = rng.uniform(-2, 2, b)
        robots[0:2, 1:] += 2.5  # the others out of the way
    if scene == "kick":
        cmd[8] = rng.uniform(-1, 5, (n, b))
        cmd[9] = rng.uniform(0, 3, (n, b)) * (rng.uniform(size=(n, b)) < 0.5)
    if scene == "dribble":
        cmd[10] = 1.0
    return ball, robots, cmd


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


def _commands(mod, xp, cmd):
    return mod.SSLCommands(
        wheel_speed=xp(cmd[0] > 0.5), v_wheel=xp(np.ascontiguousarray(cmd[1:5].transpose(1, 0, 2))),
        v_x=xp(cmd[5]), v_y=xp(cmd[6]), v_theta=xp(cmd[7]),
        kick_v_x=xp(cmd[8]), kick_v_z=xp(cmd[9]), dribbler=xp(cmd[10] > 0.5),
    )


def _assert_worlds_close(got, want, atol, wheel_atol):
    names = ["ball." + k for k in jstate.BallState._fields] + [
        "robots." + k for k in jstate.RobotsState._fields
    ]
    for name, g, w in zip(names, jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        if name == "robots.infrared":
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        if name == "robots.theta":  # same angle across the +-pi wrap
            g = np.remainder(g - w + np.pi, 2 * np.pi) - np.pi
            w = np.zeros_like(w)
        tol = wheel_atol if name == "robots.v_wheel" else atol
        np.testing.assert_allclose(g, w, atol=tol, err_msg=name)


def test_wheel_jacobian_equals_jax():
    np.testing.assert_array_equal(wheel_jacobian(FIELD), j_wheel_jacobian(j_ssl_field(2)))


@pytest.mark.parametrize("scene", SCENES)
def test_ssl_step_matches_jax(scene):
    rng = np.random.default_rng(SCENES.index(scene))
    ball, robots, cmd = random_worlds(rng, 64, scene)
    j_step = jax.vmap(j_make_step(j_ssl_field(2), J_PHYS, DT), in_axes=-1, out_axes=-1)
    t_step = make_ssl_step(FIELD, SSL_PHYSICS, DT)
    jw = _world(jstate, jnp.asarray, ball, robots)
    tw = _world(tstate, torch.from_numpy, ball, robots)
    jc = _commands(jstate, jnp.asarray, cmd)
    tc = _commands(tstate, torch.from_numpy, cmd)
    for t in range(3):  # a few control steps of the same commands
        jw = j_step(jw, jc)
        tw = t_step(tw, tc)
        got = jax.tree.map(lambda x: x.numpy(), tw, is_leaf=torch.is_tensor)
        _assert_worlds_close(got, jw, ATOL, ATOL)
        if scene == "dribble" and t == 0:  # the scene exercises its path
            assert got.robots.infrared[0].any()
        if scene == "kick" and t == 0:
            assert (np.hypot(got.ball.v_x, got.ball.v_y) > 1.0).any()
            assert (got.ball.v_z > 0).any()


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
@pytest.mark.parametrize("scene", SCENES)
def test_ssl_step_matches_native_oracle(scene):
    """Per step, to 2e-4 (wheel speeds 5e-3, infrared exact), against
    csrc/ssl_physics.cpp, as tests/test_native_oracle.py holds the JAX
    step."""
    from rsoccer_tpu.ops.native import ssl_step_native

    rng = np.random.default_rng(10 + SCENES.index(scene))
    b = 8
    ball, robots, cmd = random_worlds(rng, b, scene)
    tw = make_ssl_step(FIELD, SSL_PHYSICS, DT)(
        _world(tstate, torch.from_numpy, ball, robots), _commands(tstate, torch.from_numpy, cmd)
    )
    for e in range(b):
        b_c = np.ascontiguousarray(ball[:, e])
        r_c = np.ascontiguousarray(robots[:, :, e].T)  # (N, 6)
        ir, wheels = ssl_step_native(j_ssl_field(2), J_PHYS, DT, b_c, r_c,
                                     np.ascontiguousarray(cmd[:, :, e].T))
        got_b = np.array([getattr(tw.ball, k)[e].item() for k in tstate.BallState._fields])
        np.testing.assert_allclose(got_b, b_c, atol=2e-4, err_msg=f"env {e} ball")
        got_r = np.stack([getattr(tw.robots, k)[:, e].numpy() for k in tstate.RobotsState._fields[:6]], -1)
        dth = np.remainder(got_r[:, 2] - r_c[:, 2] + np.pi, 2 * np.pi) - np.pi
        got_r[:, 2], r_c[:, 2] = dth, 0.0
        np.testing.assert_allclose(got_r, r_c, atol=2e-4, err_msg=f"env {e} robots")
        np.testing.assert_array_equal(tw.robots.infrared[:, e].numpy(), ir, err_msg=f"env {e} ir")
        np.testing.assert_allclose(tw.robots.v_wheel[:, :, e].numpy(), wheels, atol=5e-3,
                                   err_msg=f"env {e} wheels")
