"""The VSS physics-only step (``ops/vss_physics``): its plain version vs the
JAX package's Pallas kernel (interpret mode, N = 1, 6 and 10 robots) and
XLA step on the same arrays, the kernel's parameter struct, the wrapper's
dispatch and kernel routes, and ``BatchedEnv(..., fused_physics=True)`` vs
the unfused env step and the JAX package's ``pallas_physics`` step fed the
same noise, at 3v3 and 5v5."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu.batch.vecenv import BatchedEnv as JBatchedEnv
from rsoccer_tpu.ops import pallas_vss as jpv
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.batch import rollout as R
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.envs.vss import VSSState
from rsoccer_tpu_torch.ops import vss_physics as vp
from rsoccer_tpu_torch.physics.vss import make_vss_step
from rsoccer_tpu_torch.utils import tracing
from tests.test_pallas_vss import B, DT, FIELD, N, random_batched_world, xla_reference
from tests.test_torch_env_vss import assert_states_close, np_noise

torch.set_num_threads(1)

ATOL = 5e-5
PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rsoccer_tpu_torch")
# env kwargs by robot count: 1v0, 3v3, VSS's 5v5 division on its own field
TEAMS = {1: dict(n_robots_blue=1, n_robots_yellow=0), 6: {},
         10: dict(field_type=1, n_robots_blue=5, n_robots_yellow=5)}


def assert_arrays_close(got, want, tag):
    """(robots, ball) of the port vs a JAX step's; headings on the circle."""
    rb, ball = (np.asarray(a) for a in got)
    w_rb, w_ball = (np.asarray(a) for a in want)
    d_th = np.remainder(rb[2] - w_rb[2] + np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(d_th, 0.0, atol=ATOL, err_msg=f"{tag} theta")
    np.testing.assert_allclose(rb[[0, 1, 3, 4, 5]], w_rb[[0, 1, 3, 4, 5]], atol=ATOL, err_msg=f"{tag} robots")
    np.testing.assert_allclose(ball, w_ball, atol=ATOL, err_msg=f"{tag} ball")


def port_arrays(rb, ball, cmds):
    return (torch.from_numpy(np.asarray(a).copy()) for a in (rb, ball, cmds))


def random_world(rng, n):
    """tests/test_pallas_vss.random_batched_world for n robots: robots
    overlapping, half the balls airborne, wheel commands past the clamp."""
    if n == N:
        return random_batched_world(rng)
    rb = np.zeros((6, n, B), np.float32)
    rb[0] = rng.uniform(-0.6, 0.6, (n, B))
    rb[1] = rng.uniform(-0.5, 0.5, (n, B))
    rb[2] = rng.uniform(-np.pi, np.pi, (n, B))
    rb[3:5] = rng.uniform(-0.5, 0.5, (2, n, B))
    rb[5] = rng.uniform(-5, 5, (n, B))
    ball = np.zeros((6, B), np.float32)
    ball[0] = rng.uniform(-0.6, 0.6, B)
    ball[1] = rng.uniform(-0.5, 0.5, B)
    airborne = rng.uniform(size=B) < 0.5
    ball[2] = FIELD.ball_radius + np.where(airborne, rng.uniform(0, 0.3, B), 0.0)
    ball[3:5] = rng.uniform(-1, 1, (2, B))
    ball[5] = np.where(airborne, rng.uniform(-1, 2, B), 0.0)
    cmds = rng.uniform(-40, 40, (2, n, B)).astype(np.float32)
    return jnp.asarray(rb), jnp.asarray(ball), jnp.asarray(cmds)


@pytest.mark.parametrize(
    "reference, n",
    [("pallas_interpret", 6), ("xla", 6), ("pallas_interpret", 1), ("pallas_interpret", 10)],
    ids=["pallas_interpret", "xla", "pallas_interpret-n1", "pallas_interpret-n10"],
)
def test_plain_matches_jax_physics(reference, n):
    """Random worlds (half the balls airborne, robots overlapping) one
    control step: the port's plain version vs the JAX Pallas kernel and
    the JAX XLA step, to 5e-5."""
    tenv = rsoccer_tpu_torch.make("VSS-v0", **TEAMS[n])
    if reference == "xla":
        step = xla_reference
    else:
        jenv = rsoccer_tpu.make("VSS-v0", **TEAMS[n])
        step = jpv.make_pallas_vss_physics(jenv.field, jenv.physics_cfg, DT,
                                           n_robots=n, batch=B, tile=B, interpret=True)
    rng = np.random.default_rng(0)
    for trial in range(5):
        rb, ball, cmds = random_world(rng, n)
        got = vp.vss_physics_plain(tenv, *port_arrays(rb, ball, cmds))
        assert_arrays_close(got, step(rb, ball, cmds), f"trial {trial}")


def test_plain_is_the_port_world_step():
    """world_step on CPU is physics/vss's step on the same world, v_wheel
    included; the infrared leaf is carried through."""
    tenv = rsoccer_tpu_torch.make("VSS-v0")
    benv = BatchedEnv(tenv, B, device="cpu")
    state = R.init_carry(benv, seed=1).state
    cmd, _ = tenv.pre_physics(state, torch.rand((2, B)) * 2 - 1,
                              {"ou": torch.zeros((N, 2, B))})
    want = make_vss_step(tenv.field, tenv.physics_cfg, tenv.time_step)(state.world, cmd)
    got = vp.world_step(tenv, state.world, cmd)
    for g, w in zip(jax.tree.leaves(convert.state_to_numpy(got)),
                    jax.tree.leaves(convert.state_to_numpy(want))):
        np.testing.assert_allclose(g, w, atol=1e-6)


def test_kernel_param_struct_matches_cuda_source():
    """ctypes mirror of VssPhysParams == the X-list in csrc/vss_physics.cu."""
    src = open(os.path.join(PORT, "csrc", "vss_physics.cu")).read()
    block = src[src.index("#define VSS_PHYS_PARAMS(X)"): src.index("struct VssPhysParams")]
    assert re.findall(r"X\((\w+)\)", block) == vp.PARAM_FIELDS
    assert sorted(vp.kernel_params(rsoccer_tpu_torch.make("VSS-v0"))) == sorted(vp.PARAM_FIELDS)


def test_wrapper_dispatch_on_cpu():
    """On CPU the wrapper runs the plain version and never counts a launch;
    other devices are refused."""
    tenv = rsoccer_tpu_torch.make("VSS-v0")
    rb, ball, cmds = port_arrays(*random_batched_world(np.random.default_rng(2)))
    before = tracing.snapshot()
    for g, w in zip(vp.vss_physics(tenv, rb, ball, cmds), vp.vss_physics_plain(tenv, rb, ball, cmds)):
        assert torch.equal(g, w)
    assert tracing.launches(vp.vss_physics, since=before) == 0
    with pytest.raises(NotImplementedError):
        vp.vss_physics(tenv, rb.to("meta"), ball.to("meta"), cmds.to("meta"))


@pytest.mark.parametrize("final", [False, True], ids=["step", "step_final"])
@pytest.mark.parametrize("max_steps", [None, 3], ids=["limit1200", "limit3"])
@pytest.mark.parametrize("n", [6, 10], ids=["3v3", "5v5"])
def test_fused_physics_step_matches_unfused_and_jax(n, max_steps, final):
    """BatchedEnv(fused_physics=True) vs the unfused BatchedEnv and vs the
    JAX package's pallas_physics step (its kernel in interpret mode), fed
    the same noise through auto-resets."""
    jenv, tenv = rsoccer_tpu.make("VSS-v0", **TEAMS[n]), rsoccer_tpu_torch.make("VSS-v0", **TEAMS[n])
    if max_steps is not None:
        jenv.max_episode_steps = tenv.max_episode_steps = max_steps
    fused = BatchedEnv(tenv, B, device="cpu", fused_physics=True)
    twin = BatchedEnv(tenv, B, device="cpu")
    jbenv = JBatchedEnv(jenv, B, pallas_physics=True, pallas_tile=B)
    j_step = jax.jit(jbenv._pallas_step)
    rng = np.random.default_rng(11)
    r0 = np_noise(rng, tenv.reset_noise_spec(), B)
    ts = tenv.reset_state(convert.noise_from_numpy(r0, device="cpu"))
    js = jax.vmap(jenv.reset_state, in_axes=-1, out_axes=-1)({k: jnp.asarray(v) for k, v in r0.items()})
    dones = 0
    for t in range(5):
        act = rng.uniform(-1, 1, (2, B)).astype(np.float32)
        tn, rn = (np_noise(rng, spec, B) for spec in (tenv.transition_noise_spec(), tenv.reset_noise_spec()))
        t_noise, r_noise = (convert.noise_from_numpy(n, device="cpu") for n in (tn, rn))
        step = fused.step_final_with_noise if final else fused.step_with_noise
        plain = twin.step_final_with_noise if final else twin.step_with_noise
        got = step(ts, torch.from_numpy(act), t_noise, r_noise)
        want = plain(ts, torch.from_numpy(act), t_noise, r_noise)
        assert isinstance(got[0], VSSState) and len(got) == len(want) == (7 if final else 6)
        assert_states_close(got[0], convert.state_to_numpy(want[0]), tag=f"step {t} unfused")
        for g, w in zip(got[1:-1], want[1:-1]):
            torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
        for k in want[-1]:
            torch.testing.assert_close(got[-1][k], want[-1][k], rtol=0, atol=ATOL)
        jo = j_step(js, jnp.asarray(act), {k: jnp.asarray(v) for k, v in tn.items()},
                    {k: jnp.asarray(v) for k, v in rn.items()})
        assert_states_close(got[0], jo[0], tag=f"step {t} jax")
        np.testing.assert_allclose(got[1].numpy(), np.asarray(jo[1]), atol=ATOL)
        np.testing.assert_allclose(got[-4].numpy(), np.asarray(jo[2]), atol=ATOL)
        np.testing.assert_array_equal(got[-3].numpy(), np.asarray(jo[3]))
        np.testing.assert_array_equal(got[-2].numpy(), np.asarray(jo[4]))
        dones += int((got[-3] | got[-2]).sum())
        ts, js = got[0], jo[0]
    if max_steps is not None:
        assert dones > 0


def test_fused_physics_rollout_matches_unfused():
    """The rollout through fused_physics (its plain version here) and the
    unfused one give the same metrics and final obs."""
    env = rsoccer_tpu_torch.make("VSS-v0")
    env.max_episode_steps = 4
    fused = BatchedEnv(env, B, device="cpu", fused_physics=True)
    twin = BatchedEnv(env, B, device="cpu")
    c_f, m_f = R.make_rollout_fn(fused, 10)(R.init_carry(fused, seed=3))
    c_t, m_t = R.make_rollout_fn(twin, 10)(R.init_carry(twin, seed=3))
    assert int(m_f.episodes) > 0 and int(m_f.episodes) == int(m_t.episodes)
    for a, b in zip(m_f, m_t):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    torch.testing.assert_close(c_f.obs, c_t.obs, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n, route", [(6, "group"), (1, "thread"), (10, "group")])
def test_route_by_robot_count(n, route):
    """N = 6 runs on the 8-lane group kernel and N = 10 on the 16-lane one,
    each up to its crossover (GROUP_MAX_ENVS), every other N on the
    one-thread kernel; above its crossover every N runs one thread per
    env."""
    env = rsoccer_tpu_torch.make("VSS-v0", **TEAMS[n])
    assert vp.route(env, B) == route
    assert vp.route(env, 8192) == route  # the main path's batch
    assert vp.route(env, vp.GROUP_MAX_ENVS.get(n, vp.VSS_GROUP_MAX_ENVS)) == route
    assert vp.route(env, vp.GROUP_MAX_ENVS.get(n, 0) + 1) == "thread"


@pytest.mark.parametrize("delta", [-1, 0, 1, 4096])
def test_route_at_the_5v5_crossover(delta):
    env = rsoccer_tpu_torch.make("VSS-v0", **TEAMS[10])
    want = "group" if delta <= 0 else "thread"
    assert vp.route(env, vp.VSS_10_GROUP_MAX_ENVS + delta) == want
    assert vp.routed_entry(env, vp.VSS_10_GROUP_MAX_ENVS + delta) == (
        "vss_physics_step" if want == "group" else "vss_physics_step_one_thread")


def test_route_refuses_outside_the_range():
    env = rsoccer_tpu_torch.make("VSS-v0", n_robots_blue=6, n_robots_yellow=5)
    with pytest.raises(NotImplementedError, match="1-10 robots"):
        vp.route(env, B)


def test_make_vec_5v5_fused_physics_rollout_matches_unfused():
    """make_vec passes fused_physics through: the 5v5 rollout through the
    physics kernel's plain version here gives the unfused rollout's metrics
    and final obs."""
    benvs = [rsoccer_tpu_torch.make_vec("VSS-v0", B, device="cpu", fused_physics=fp, **TEAMS[10])
             for fp in (True, False)]
    assert benvs[0].fused_physics and not benvs[1].fused_physics
    out = []
    for benv in benvs:
        benv.env.max_episode_steps = 4
        out.append(R.make_rollout_fn(benv, 10)(R.init_carry(benv, seed=3)))
    (c_f, m_f), (c_t, m_t) = out
    assert int(m_f.episodes) > 0 and int(m_f.episodes) == int(m_t.episodes)
    for a, b in zip(m_f, m_t):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    torch.testing.assert_close(c_f.obs, c_t.obs, rtol=0, atol=ATOL)
    assert tuple(c_f.obs.shape) == (64, B)
