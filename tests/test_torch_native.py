"""The port's binding of the C++ physics oracles (``rsoccer_tpu_torch/ops/
native.py``): bit for bit the JAX package's binding on the same worlds, the
batched walkers equal to a loop over envs, and the port's plain VSS and SSL
steps within the oracle protocol (2e-4 per step; wheel speeds 5e-3;
infrared exact) of the port's own binding."""

import shutil

import numpy as np
import pytest
import torch

from rsoccer_tpu.core.field import ssl_field as j_ssl_field
from rsoccer_tpu.core.field import vss_field as j_vss_field
from rsoccer_tpu.ops import native as jnative
from rsoccer_tpu.physics.config import SSL_PHYSICS as J_SSL_PHYS
from rsoccer_tpu.physics.config import VSS_PHYSICS as J_VSS_PHYS
from rsoccer_tpu_torch.core import state as tstate
from rsoccer_tpu_torch.core.field import ssl_field, vss_field
from rsoccer_tpu_torch.ops import native
from rsoccer_tpu_torch.physics.config import SSL_PHYSICS, VSS_PHYSICS
from rsoccer_tpu_torch.physics.ssl import make_ssl_step
from rsoccer_tpu_torch.physics.vss import make_vss_step
from tests.test_torch_physics_ssl import SCENES as SSL_SCENES
from tests.test_torch_physics_ssl import _commands as ssl_commands
from tests.test_torch_physics_ssl import random_worlds as ssl_worlds
from tests.test_torch_physics_vss import _world, crowded_worlds

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

torch.set_num_threads(1)

DT = 0.025
VSS_SCENES = ["crowded", "pockets", "walls"]
B = 32


def _vss_case(scene, b=B, seed=0):
    rng = np.random.default_rng(seed + VSS_SCENES.index(scene))
    ball, robots, cmds = crowded_worlds(rng, b, scene=scene)
    return ball, robots, cmds


def _ssl_case(scene, b=B, seed=0):
    rng = np.random.default_rng(seed + SSL_SCENES.index(scene))
    return ssl_worlds(rng, b, scene)


def test_builds_into_the_port_build_dir():
    native.vss_step_native(vss_field(0), VSS_PHYSICS, DT, np.zeros(6, np.float32),
                           np.zeros((1, 6), np.float32), np.zeros((1, 2), np.float32))
    for name in ("vss_physics", "ssl_physics"):
        path = native.library_path(name)
        assert path.parent == native.BUILD_DIR and path.parent.name == "_build"
        assert path.parent.parent.name == "rsoccer_tpu_torch"


@pytest.mark.parametrize("scene", VSS_SCENES)
def test_vss_step_native_bit_equal_jax_binding(scene):
    ball, robots, cmds = _vss_case(scene, b=8)
    for e in range(8):
        b_t, b_j = (np.ascontiguousarray(ball[:, e]) for _ in range(2))
        r_t, r_j = (np.ascontiguousarray(robots[:, :, e].T) for _ in range(2))
        c = np.ascontiguousarray(cmds[:, :, e].T)
        w_t = native.vss_step_native(vss_field(0), VSS_PHYSICS, DT, b_t, r_t, c)
        w_j = jnative.vss_step_native(j_vss_field(0), J_VSS_PHYS, DT, b_j, r_j, c)
        np.testing.assert_array_equal(b_t, b_j)
        np.testing.assert_array_equal(r_t, r_j)
        np.testing.assert_array_equal(w_t, w_j)
        assert not np.array_equal(b_t, ball[:, e])  # the world moved


@pytest.mark.parametrize("scene", SSL_SCENES)
def test_ssl_step_native_bit_equal_jax_binding(scene):
    ball, robots, cmd = _ssl_case(scene, b=8)
    for e in range(8):
        b_t, b_j = (np.ascontiguousarray(ball[:, e]) for _ in range(2))
        r_t, r_j = (np.ascontiguousarray(robots[:, :, e].T) for _ in range(2))
        c = np.ascontiguousarray(cmd[:, :, e].T)
        ir_t, w_t = native.ssl_step_native(ssl_field(2), SSL_PHYSICS, DT, b_t, r_t, c)
        ir_j, w_j = jnative.ssl_step_native(j_ssl_field(2), J_SSL_PHYS, DT, b_j, r_j, c)
        for got, want in ((b_t, b_j), (r_t, r_j), (ir_t, ir_j), (w_t, w_j)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene", VSS_SCENES)
def test_batched_vss_oracle_equals_env_loop(scene):
    ball, robots, cmds = _vss_case(scene)
    world = _world(tstate, torch.from_numpy, ball, robots)
    got = native.batched_vss_oracle(world, tstate.VSSCommands(*torch.from_numpy(cmds)),
                                    vss_field(0), VSS_PHYSICS, DT)
    for e in range(B):
        b_c = np.ascontiguousarray(ball[:, e])
        r_c = np.ascontiguousarray(robots[:, :, e].T)
        wheels = native.vss_step_native(vss_field(0), VSS_PHYSICS, DT, b_c, r_c,
                                        np.ascontiguousarray(cmds[:, :, e].T))
        np.testing.assert_array_equal(np.stack([t[e].numpy() for t in got.ball]), b_c)
        np.testing.assert_array_equal(np.stack([t[:, e].numpy() for t in got.robots[:6]], -1), r_c)
        np.testing.assert_array_equal(got.robots.v_wheel[:, :2, e].numpy(), wheels)
    assert not got.robots.v_wheel[:, 2:].any()
    assert not got.robots.infrared.any()


@pytest.mark.parametrize("scene", SSL_SCENES)
def test_batched_ssl_oracle_equals_env_loop(scene):
    ball, robots, cmd = _ssl_case(scene)
    world = _world(tstate, torch.from_numpy, ball, robots)
    got = native.batched_ssl_oracle(world, ssl_commands(tstate, torch.from_numpy, cmd),
                                    ssl_field(2), SSL_PHYSICS, DT)
    for e in range(B):
        b_c = np.ascontiguousarray(ball[:, e])
        r_c = np.ascontiguousarray(robots[:, :, e].T)
        ir, wheels = native.ssl_step_native(ssl_field(2), SSL_PHYSICS, DT, b_c, r_c,
                                            np.ascontiguousarray(cmd[:, :, e].T))
        np.testing.assert_array_equal(np.stack([t[e].numpy() for t in got.ball]), b_c)
        np.testing.assert_array_equal(np.stack([t[:, e].numpy() for t in got.robots[:6]], -1), r_c)
        np.testing.assert_array_equal(got.robots.infrared[:, e].numpy(), ir)
        np.testing.assert_array_equal(got.robots.v_wheel[:, :, e].numpy(), wheels)


def test_ssl_command_rows_are_the_oracle_slots():
    _, _, cmd = _ssl_case("kick", b=4)
    rows = native.ssl_command_rows(ssl_commands(tstate, torch.from_numpy, cmd))
    np.testing.assert_array_equal(rows, cmd.transpose(2, 1, 0))


@pytest.mark.parametrize("scene", VSS_SCENES)
def test_plain_vss_step_within_oracle(scene):
    """Each of 5 steps from the plain step's state, at 3v3 on the 3v3
    field and at 5v5 on its own field."""
    for field_type, n in ((0, 6), (1, 10)):
        field = vss_field(field_type)
        rng = np.random.default_rng(20 + VSS_SCENES.index(scene))
        ball, robots, cmds = crowded_worlds(rng, B, n=n, scene=scene)
        world = _world(tstate, torch.from_numpy, ball, robots)
        step = make_vss_step(field, VSS_PHYSICS, DT)
        for t in range(5):
            c = tstate.VSSCommands(*torch.from_numpy(rng.uniform(-50, 50, (2, n, B)).astype(np.float32)))
            got, want = step(world, c), native.batched_vss_oracle(world, c, field, VSS_PHYSICS, DT)
            native.check_oracle(native.world_errors(got, want), f"{scene} field {field_type} step {t}")
            world = got


@pytest.mark.parametrize("scene", SSL_SCENES)
def test_plain_ssl_step_within_oracle(scene):
    ball, robots, cmd = _ssl_case(scene, seed=30)
    world = _world(tstate, torch.from_numpy, ball, robots)
    commands = ssl_commands(tstate, torch.from_numpy, cmd)
    step = make_ssl_step(ssl_field(2), SSL_PHYSICS, DT)
    for t in range(3):
        got, want = step(world, commands), native.batched_ssl_oracle(world, commands, ssl_field(2),
                                                                    SSL_PHYSICS, DT)
        native.check_oracle(native.world_errors(got, want), f"{scene} step {t}")
        world = got


def test_check_oracle_raises_past_its_tolerance():
    ball, robots, cmds = _vss_case("crowded", b=4)
    world = _world(tstate, torch.from_numpy, ball, robots)
    want = native.batched_vss_oracle(world, tstate.VSSCommands(*torch.from_numpy(cmds)),
                                     vss_field(0), VSS_PHYSICS, DT)
    bumped = want._replace(ball=want.ball._replace(x=want.ball.x + 3e-4))
    errs = native.world_errors(bumped, want)
    assert errs["ball.x"] == pytest.approx(3e-4, rel=1e-3) and errs["ball.y"] == 0
    with pytest.raises(AssertionError, match="ball.x"):
        native.check_oracle(errs)


def test_single_env_steps_refuse_bad_shapes():
    f32 = np.float32
    with pytest.raises(ValueError, match="commands"):
        native.vss_step_native(vss_field(0), VSS_PHYSICS, DT, np.zeros(6, f32), np.zeros((3, 6), f32),
                               np.zeros((2, 2), f32))
    with pytest.raises(ValueError, match="ball"):
        native.ssl_step_native(ssl_field(2), SSL_PHYSICS, DT, np.zeros(5, f32), np.zeros((3, 6), f32),
                               np.zeros((3, 11), f32))
