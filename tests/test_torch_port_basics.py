"""The PyTorch port's scaffold: no JAX inside it, copied tables equal to
the JAX package's, state conversion and the packed kernel layout."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu.batch.vecenv import BatchedEnv as JaxBatchedEnv
from rsoccer_tpu.core import field as jfield
from rsoccer_tpu.ops import pallas_vss_full as jpvf
from rsoccer_tpu.physics import config as jconfig
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.core import field as tfield
from rsoccer_tpu_torch.envs.vss import VSSState
from rsoccer_tpu_torch.ops import vss_full as tvf
from rsoccer_tpu_torch.physics import config as tconfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "rsoccer_tpu_torch")


def _jax_reset(b=16, seed=0):
    env = rsoccer_tpu.make("VSS-v0")
    state, obs = JaxBatchedEnv(env, b).reset(jax.random.PRNGKey(seed))
    return env, state, obs


def test_port_imports_no_jax():
    code = (
        "import sys, rsoccer_tpu_torch, rsoccer_tpu_torch.batch.rollout, "
        "rsoccer_tpu_torch.ops.vss_full, rsoccer_tpu_torch.ops.ssl_full, "
        "rsoccer_tpu_torch.ops.vss_physics, rsoccer_tpu_torch.ops.native, "
        "rsoccer_tpu_torch.tools.calibrate, rsoccer_tpu_torch.convert; "
        "assert 'jax' not in sys.modules, 'jax was imported'; print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_and_chip_smoke_import_neither_jax_nor_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports jax or any
    module of rsoccer_tpu (whose __init__ loads jax)."""
    pat = re.compile(r"^\s*(import\s+(jax|rsoccer_tpu)\b(?!_)|from\s+(jax|rsoccer_tpu)\b(?!_))", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = [os.path.relpath(p, REPO) for p in paths if pat.search(open(p).read())]
    assert len(paths) > 20 and not offenders, offenders


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    offenders = []
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not sources
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                if pat.search(open(path).read()):
                    offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


@pytest.mark.parametrize(
    "port, ref",
    [
        (tfield.vss_field(0), jfield.vss_field(0)),
        (tfield.vss_field(1), jfield.vss_field(1)),
        (tconfig.VSS_PHYSICS, jconfig.VSS_PHYSICS),
        (tconfig.PhysicsConfig(), jconfig.PhysicsConfig()),
    ],
    ids=["vss_field0", "vss_field1", "VSS_PHYSICS", "PhysicsConfig_defaults"],
)
def test_copied_tables_equal_jax(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("ft", [0, 1])
def test_derived_field_values_equal_jax(ft):
    p, r = tfield.vss_field(ft), jfield.vss_field(ft)
    for name in ("half_length", "half_width", "max_pos", "max_wheel_rad_s", "max_v"):
        assert getattr(p, name) == getattr(r, name), name


def test_convert_round_trips():
    _, state, _ = _jax_reset()
    np_state = jax.tree.map(np.asarray, state)
    port = convert.state_from_numpy(np_state, VSSState, device="cpu")
    assert port.steps.dtype == torch.int32
    assert port.has_potential.dtype == torch.bool
    back = convert.state_to_numpy(port)
    for a, b in zip(jax.tree.leaves(np_state), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = convert.state_from_numpy(back, VSSState, device="cpu")
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(again)):
        assert torch.equal(a, b)

    rng = np.random.default_rng(0)
    noise = {"ou": rng.normal(size=(6, 2, 4)).astype(np.float32)}
    got = convert.noise_to_numpy(convert.noise_from_numpy(noise, device="cpu"))
    np.testing.assert_array_equal(got["ou"], noise["ou"])


def test_pack_unpack_equal_jax():
    env, state, _ = _jax_reset(b=16, seed=3)
    # step once so velocities, OU, potential and shaping are non-trivial
    benv = JaxBatchedEnv(env, 16)
    acts = jnp.asarray(np.random.default_rng(1).uniform(-1, 1, (2, 16)), jnp.float32)
    state = benv.step(state, acts, jax.random.PRNGKey(9))[0]
    np_state = jax.tree.map(np.asarray, state)

    packed_j = np.asarray(jpvf.pack_vss_state(state))
    packed_t = tvf.pack_vss_state(convert.state_from_numpy(np_state, VSSState, device="cpu"))
    assert packed_t.shape == (tvf.state_size(6), 16)
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)

    un_j = jax.tree.map(
        np.asarray, jpvf.unpack_vss_state(jnp.asarray(packed_j), 6, env.field.rbt_wheel_radius)
    )
    un_t = convert.state_to_numpy(
        tvf.unpack_vss_state(packed_t, 6, env.field.rbt_wheel_radius)
    )
    for a, b in zip(jax.tree.leaves(un_j), jax.tree.leaves(un_t)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(b, a, atol=1e-6)  # v_wheel recomputed


def test_registry_and_make_vec():
    env = rsoccer_tpu_torch.make("VSS-v0")
    assert (env.obs_size, env.action_size, env.max_episode_steps) == (40, 2, 1200)
    assert rsoccer_tpu_torch.registered_ids() == [
        "SSLContestedPossession-v0", "SSLDribbling-v0", "SSLPassEndurance-v0",
        "SSLStaticDefenders-v0", "VSS-v0", "VSSMultiAgent-v0", "VSSSelfPlay-v0"]
    assert rsoccer_tpu_torch.make("VSSSelfPlay-v0").action_size == 12
    with pytest.raises(KeyError):
        rsoccer_tpu_torch.make("nope-v0")
    benv = rsoccer_tpu_torch.make_vec("VSS-v0", 8, device="cpu", fused=True, field_type=1)
    assert benv.env.field == tfield.vss_field(1) and benv.fused


def test_batched_env_refuses_unported_paths():
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv

    env = rsoccer_tpu_torch.make("VSS-v0")
    with pytest.raises(ValueError, match="pick one"):
        BatchedEnv(env, 8, device="cpu", fused=True, fused_physics=True)
    with pytest.raises(NotImplementedError, match="VSS envs only"):
        BatchedEnv(rsoccer_tpu_torch.make("SSLDribbling-v0"), 8, device="cpu", fused_physics=True)
    with pytest.raises(ValueError):
        BatchedEnv(env, 8, device="cpu", fused=True, fused_rng="hardware")


def test_kernel_param_struct_matches_cuda_source():
    """ctypes mirror of VssParams == the X-list in csrc/vss_step.cuh (the
    header both VSS step designs share)."""
    src = open(os.path.join(PORT, "csrc", "vss_step.cuh")).read()
    block = src[src.index("#define VSS_PARAMS(X)"): src.index("struct VssParams")]
    fields = re.findall(r"X\((\w+)\)", block)
    assert fields == tvf.PARAM_FIELDS
    env = rsoccer_tpu_torch.make("VSS-v0")
    assert sorted(tvf.kernel_params(env)) == sorted(tvf.PARAM_FIELDS)
    assert tvf.taylor_rotation_holds(env)  # VSS-v0's turn bound admits Taylor
    assert not tvf.taylor_rotation_holds(rsoccer_tpu_torch.make("VSS-v0", time_step=0.2))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """No CUDA device: chip_smoke.py exits non-zero and prints no result,
    from the repo and from a directory holding the script alone."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run for real")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_build_without_nvcc_raises(monkeypatch):
    """No nvcc: the build raises (with the places it looked); nothing
    falls back to the plain version."""
    from rsoccer_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a system nvcc exists at /usr/local/cuda/bin")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("n, batch", [(6, 1), (10, 3)])
def test_make_world_equals_jax(n, batch):
    """``core/state.make_world`` is the JAX package's, batch-last."""
    from rsoccer_tpu.core import state as jstate
    from rsoccer_tpu_torch.core import state as tstate

    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate.make_world(n)))
    got = jax.tree.leaves(convert.state_to_numpy(tstate.make_world(n, batch=batch, device="cpu")))
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, np.broadcast_to(w[..., None], w.shape + (batch,)))


def test_register_then_make_custom_id(monkeypatch):
    from rsoccer_tpu_torch import registry
    from rsoccer_tpu_torch.envs.vss import VSSEnv

    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))  # a copy of its own
    registry.register("VSSSolo-v0", lambda **kw: VSSEnv(**{"n_robots_blue": 1, "n_robots_yellow": 0, **kw}))
    assert "VSSSolo-v0" in rsoccer_tpu_torch.registered_ids()
    env = rsoccer_tpu_torch.make("VSSSolo-v0", time_step=0.1)
    assert (env.n_robots, env.time_step) == (1, 0.1)
    benv = rsoccer_tpu_torch.make_vec("VSSSolo-v0", 4, device="cpu")
    assert benv.env.n_robots == 1
    registry.register("VSS-v0", lambda **kw: "replaced")  # a later factory wins
    assert rsoccer_tpu_torch.make("VSS-v0") == "replaced"


def test_keyed_ou_step_is_its_pure_core():
    """``ou_step`` is ``ou_update`` of the normals drawn at its key (which
    advances); ``ou_update`` is the JAX package's; ``ou_reset`` zeros."""
    from rsoccer_tpu.envs import ou as jou
    from rsoccer_tpu_torch.envs import ou as tou
    from rsoccer_tpu_torch.envs.base import draw_noise
    from rsoccer_tpu_torch.ops.philox import make_key

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 2, 512)).astype(np.float32))
    key = make_key(5, device="cpu")
    twin = key.clone()
    got = tou.ou_step(x, key, 0.025, mu=0.1, sigma=0.4)
    assert int(key[2]) == 1
    noise = draw_noise(twin, {"n": ((6, 2), "normal")}, 512)["n"]
    torch.testing.assert_close(got, tou.ou_update(x, noise, 0.025, mu=0.1, sigma=0.4), rtol=0, atol=0)
    want = jou.ou_update(jnp.asarray(x.numpy()), jnp.asarray(noise.numpy()), 0.025, mu=0.1, sigma=0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert abs(float(noise.mean())) < 0.05 and abs(float(noise.std()) - 1.0) < 0.05
    assert not torch.equal(tou.ou_step(x, key, 0.025), got)  # the next step draws anew
    z = tou.ou_reset((6, 2, 4), device="cpu")
    assert z.shape == (6, 2, 4) and not z.any()


def test_keyed_spawn_is_its_pure_core():
    """``sample_separated`` is ``place_separated`` of the uniforms drawn at
    its key, which is the JAX package's on equal draws; its points lie in
    the box, apart; ``uniform_angles`` likewise over
    ``angles_from_uniform``."""
    from rsoccer_tpu.envs import spawn as jspawn
    from rsoccer_tpu_torch.envs import spawn as tspawn
    from rsoccer_tpu_torch.envs.base import draw_noise
    from rsoccer_tpu_torch.ops.philox import make_key

    box, min_dist, b = (-0.6, 0.6, -0.5, 0.5), 0.15, 64
    key = make_key(3, device="cpu")
    twin = key.clone()
    xs, ys = tspawn.sample_separated(key, 5, *box, min_dist, preplaced_x=(0.0,), preplaced_y=(0.0,), batch=b)
    assert xs.shape == ys.shape == (5, b) and int(key[2]) == 1
    u = draw_noise(twin, {"u": ((5, 2, tspawn.N_CANDIDATES), "uniform")}, b)["u"]
    want = tspawn.place_separated(u, *box, min_dist, (0.0,), (0.0,))
    assert torch.equal(xs, want[0]) and torch.equal(ys, want[1])
    j_place = jax.vmap(lambda uu: jspawn.place_separated(uu, *box, min_dist, jnp.zeros(1), jnp.zeros(1)),
                       in_axes=-1, out_axes=-1)
    jx, jy = j_place(jnp.asarray(u.numpy()))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jy))
    assert ((xs >= box[0]) & (xs < box[1]) & (ys >= box[2]) & (ys < box[3])).all()
    px, py = torch.cat([torch.zeros(1, b), xs]), torch.cat([torch.zeros(1, b), ys])
    d = torch.hypot(px[:, None] - px[None], py[:, None] - py[None]) + torch.eye(6)[:, :, None]
    assert (d >= min_dist).all()

    twin = key.clone()
    ang = tspawn.uniform_angles(key, 6, batch=b)
    u = draw_noise(twin, {"u": ((6,), "uniform")}, b)["u"]
    assert ang.shape == (6, b) and torch.equal(ang, tspawn.angles_from_uniform(u))
    assert ((ang >= 0) & (ang < 2 * np.pi)).all()
    np.testing.assert_allclose(ang.numpy(), np.asarray(jspawn.angles_from_uniform(jnp.asarray(u.numpy()))),
                               rtol=0, atol=1e-6)


def test_trajectory_from_numpy_round_trips():
    """A JAX time-first stack of worlds and commands -> the port's
    time-last trajectory and back."""
    from rsoccer_tpu.core import state as jstate
    from rsoccer_tpu_torch.core import state as tstate

    rng = np.random.default_rng(2)
    worlds = [jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(a.dtype)) if a.dtype != bool
                           else jnp.asarray(rng.uniform(size=a.shape) < 0.5), jstate.make_world(6))
              for _ in range(5)]
    stack = jax.tree.map(lambda *ls: np.stack([np.asarray(x) for x in ls]), *worlds)
    traj = convert.trajectory_from_numpy(stack, tstate.WorldState, device="cpu")
    assert traj.ball.x.shape == (5,) and traj.robots.x.shape == (6, 5)
    assert traj.robots.v_wheel.shape == (6, 4, 5) and traj.robots.infrared.dtype == torch.bool
    for t in range(5):
        np.testing.assert_array_equal(traj.robots.v_wheel[:, :, t].numpy(), stack.robots.v_wheel[t])
        np.testing.assert_array_equal(traj.robots.theta[:, t].numpy(), stack.robots.theta[t])
    back = convert.trajectory_to_numpy(traj)
    for a, b in zip(jax.tree.leaves(stack), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and b.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
    cmds = jstate.VSSCommands(*rng.uniform(-30, 30, (2, 4, 6)).astype(np.float32))
    tc = convert.trajectory_from_numpy(cmds, tstate.VSSCommands, device="cpu")
    assert tc.v_wheel0.shape == (6, 4)
    np.testing.assert_array_equal(tc.v_wheel1.numpy(), cmds.v_wheel1.T)
    np.testing.assert_array_equal(convert.trajectory_to_numpy(tc).v_wheel0, cmds.v_wheel0)
