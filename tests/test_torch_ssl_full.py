"""The fused SSL steps' plain versions vs the JAX package's Pallas kernels
(interpret mode) for SSLStaticDefenders-v0, SSLContestedPossession-v0,
SSLDribbling-v0 and SSLPassEndurance-v0, their kernel-RNG mode through the
Philox rows, the packed layout, the kernels' parameter struct, the fused
BatchedEnv and rollout, and the port's default device.

Dribbling and PassEndurance are held lane by lane: the JAX kernel tests a
dribbling robot's kicker face after the ball's positional push, the JAX
XLA env and the port before it (``dribbler_face_lanes``)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu.ops import pallas_ssl_full as jpsf
from rsoccer_tpu_torch.batch import rollout as R
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.envs.base import step_noise_spec
from rsoccer_tpu_torch.envs.ssl_static_defenders import SSLStaticDefendersEnv
from rsoccer_tpu_torch.ops import philox
from rsoccer_tpu_torch.ops import ssl_full as sf
from rsoccer_tpu_torch.utils import tracing

torch.set_num_threads(1)

B = 16
ATOL = 5e-5
PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rsoccer_tpu_torch")
SD, CP = "SSLStaticDefenders-v0", "SSLContestedPossession-v0"
DR, PE = "SSLDribbling-v0", "SSLPassEndurance-v0"
TASKS = {  # env id -> (JAX kernel factory, port plain, port wrapper, port draw)
    SD: (jpsf.make_pallas_sd_full_step, sf.sd_full_step_plain, sf.sd_full_step, sf.sd_draw_step_rows),
    CP: (jpsf.make_pallas_cp_full_step, sf.cp_full_step_plain, sf.cp_full_step, sf.cp_draw_step_rows),
    DR: (jpsf.make_pallas_dr_full_step, sf.dr_full_step_plain, sf.dr_full_step, sf.dr_draw_step_rows),
    PE: (jpsf.make_pallas_pe_full_step, sf.pe_full_step_plain, sf.pe_full_step, sf.pe_draw_step_rows),
}
NOISE_ROWS = {SD: sf.sd_noise_rows, CP: sf.cp_noise_rows, DR: sf.dr_noise_rows, PE: sf.pe_noise_rows}
# env id -> (JAX unpack, JAX pack, info keys, port unpack, port pack, state rows)
PACKING = {
    SD: (jpsf.unpack_sd_state, jpsf.pack_sd_state, sf.SD_KEYS, sf.unpack_sd_state, sf.pack_sd_state,
         sf.sd_state_size()),
    CP: (jpsf.unpack_cp_state, jpsf.pack_cp_state, sf.CP_KEYS, sf.unpack_cp_state, sf.pack_cp_state,
         sf.cp_state_size()),
    DR: (jpsf.unpack_dr_state, jpsf.pack_dr_state, sf.DR_KEYS, sf.unpack_dr_state, sf.pack_dr_state,
         sf.dr_state_size()),
    PE: (jpsf.unpack_pe_state, jpsf.pack_pe_state, sf.PE_KEYS, sf.unpack_pe_state, sf.pack_pe_state,
         sf.pe_state_size()),
}


def pair(env_id, max_steps=None):
    jenv, tenv = rsoccer_tpu.make(env_id), rsoccer_tpu_torch.make(env_id)
    if max_steps is not None:
        jenv.max_episode_steps = tenv.max_episode_steps = max_steps
    return jenv, tenv


def reset_packed(tenv, seed):
    return BatchedEnv(tenv, B, device="cpu", fused=True).reset(philox.make_key(seed, device="cpu"))[0]


def np_rows(rng, env_id, tenv, b=B):
    """Uniform noise rows of the step, as the kernel takes them."""
    spec = step_noise_spec(tenv)
    seed = int(rng.integers(1 << 30))
    if not spec:
        return ()
    rows = philox.uniforms_from_words(philox.philox_words(
        philox.make_key(seed, device="cpu"), sum(int(np.prod(s)) for s, _ in spec.values()), b))
    noise = {}
    off = 0
    for name, (shape, _) in spec.items():
        n = int(np.prod(shape))
        noise[name] = rows[off:off + n].reshape(shape + (b,))
        off += n
    return NOISE_ROWS[env_id](tenv, noise)


_JAX_ENV_STEP = {}


def jax_env_step(env_id, jenv, st, act, rows, emit_final):
    """The JAX package's XLA env step (unpacked, vmapped step_with_noise_final,
    repacked) on packed state rows: (state, obs, aux) as the kernels lay
    them out."""
    import jax

    unpack, pack, keys = PACKING[env_id][:3]
    b = st.shape[-1]
    if env_id == DR:
        r_noise = {"_pad": jnp.zeros((1, b))}
    elif env_id == PE:
        r_noise = {"ball": jnp.asarray(rows[0].numpy()), "recv_x": jnp.asarray(rows[1].numpy())}
    else:
        raise NotImplementedError(env_id)
    k = (env_id, jenv.max_episode_steps, b)
    if k not in _JAX_ENV_STEP:
        _JAX_ENV_STEP[k] = jax.jit(jax.vmap(jenv.step_with_noise_final, in_axes=-1, out_axes=-1))
    ns, obs, fobs, rew, term, trunc, info = _JAX_ENV_STEP[k](
        unpack(jnp.asarray(st.numpy()), jenv), jnp.asarray(act.numpy()), {}, r_noise)
    aux = jnp.stack([rew, term.astype(jnp.float32), trunc.astype(jnp.float32)]
                    + [info[k] for k in keys])
    return pack(ns), jnp.concatenate([obs, fobs]) if emit_final else obs, aux


def lane_errors(n, got, want):
    """Per lane, the largest float error of (state, obs, aux) with headings
    on the circle; inf where steps, terminated or truncated differ."""
    st, obs, aux = (np.asarray(a) for a in got)
    w_st, w_obs, w_aux = (np.asarray(a) for a in want)
    d = np.abs(st - w_st)
    th = slice(6 + 2 * n, 6 + 3 * n)
    d[th] = np.abs(np.remainder(st[th] - w_st[th] + np.pi, 2 * np.pi) - np.pi)
    steps_row = 6 + 6 * n
    err = np.concatenate([d, np.abs(obs - w_obs), np.abs(aux[[0]] - w_aux[[0]]),
                          np.abs(aux[3:] - w_aux[3:])]).max(0)
    exact = (st[steps_row] == w_st[steps_row]) & (aux[1:3] == w_aux[1:3]).all(0)
    return np.where(exact, err, np.inf)


def dribbler_face_lanes(env_id, jenv, tenv, st, act, rows, emit_final, got, want, tag):
    """Hold the port's step ``got`` to the JAX kernel's ``want`` lane by
    lane.  The lanes where they differ are the dribbler-face lanes: there the
    JAX kernel departs from the JAX XLA env (it tests the face after the
    ball's positional push), and the port must agree with the XLA env.
    Returns those lanes."""
    n = tenv.n_robots
    e_kernel = lane_errors(n, got, want)
    face = np.flatnonzero(e_kernel > ATOL)
    if face.size:
        xla = jax_env_step(env_id, jenv, st, act, rows, emit_final)
        e_xla = lane_errors(n, got, xla)[face]
        e_xla_kernel = lane_errors(n, xla, want)[face]
        assert (e_xla <= ATOL).all(), f"{tag}: lanes {face[e_xla > ATOL]} differ from both JAX paths"
        assert (e_xla_kernel > ATOL).all(), f"{tag}: lanes {face} differ, the JAX paths agree there"
    return face


def assert_step_close(n, got, want, tag):
    """(state, obs, aux) of the port vs the JAX kernel's, as numpy; headings
    on the circle; steps, terminated, truncated exact."""
    st, obs, aux = (np.asarray(a) for a in got)
    w_st, w_obs, w_aux = (np.asarray(a) for a in want)
    th = slice(6 + 2 * n, 6 + 3 * n)
    steps_row = 6 + 6 * n
    d_th = np.remainder(st[th] - w_st[th] + np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(d_th, 0.0, atol=ATOL, err_msg=f"{tag} theta")
    rows = [r for r in range(st.shape[0]) if r != steps_row and not 6 + 2 * n <= r < 6 + 3 * n]
    np.testing.assert_allclose(st[rows], w_st[rows], atol=ATOL, err_msg=f"{tag} state")
    np.testing.assert_array_equal(st[steps_row], w_st[steps_row], err_msg=f"{tag} steps")
    np.testing.assert_allclose(obs, w_obs, atol=ATOL, err_msg=f"{tag} obs")
    np.testing.assert_allclose(aux[0], w_aux[0], atol=ATOL, err_msg=f"{tag} reward")
    np.testing.assert_array_equal(aux[1:3], w_aux[1:3], err_msg=f"{tag} term/trunc")
    np.testing.assert_allclose(aux[3:], w_aux[3:], atol=ATOL, err_msg=f"{tag} shaping")


@pytest.mark.parametrize(
    "env_id, emit_final, max_steps",
    [(SD, False, None), (SD, True, 3), (CP, False, 3), (CP, True, None),
     (DR, False, 3), (DR, True, None), (PE, False, None), (PE, True, 3)],
    ids=["SD-obs-limit1000", "SD-final_obs-limit3", "CP-obs-limit3", "CP-final_obs-limit1200",
         "DR-obs-limit3", "DR-final_obs-limit4800", "PE-obs-limit1200", "PE-final_obs-limit3"],
)
def test_plain_matches_jax_kernel(env_id, emit_final, max_steps):
    jmake, plain, _, _ = TASKS[env_id]
    jenv, tenv = pair(env_id, max_steps)
    jstep = jmake(jenv, B, tile=B, interpret=True, emit_final_obs=emit_final)
    rng = np.random.default_rng(31 + (max_steps or 0))
    st_t = reset_packed(tenv, seed=4)
    st_j = jnp.asarray(st_t.numpy())
    dones = 0
    for t in range(6):
        act = torch.from_numpy(rng.uniform(-1, 1, (tenv.action_size, B)).astype(np.float32))
        rows = np_rows(rng, env_id, tenv)
        want = jstep(st_j, jnp.asarray(act.numpy()), *(jnp.asarray(r.numpy()) for r in rows))
        got = plain(tenv, st_t, act, *rows, emit_final)
        assert got[1].shape == (tenv.obs_size * (2 if emit_final else 1), B)
        step_close(env_id, jenv, tenv, st_t, act, rows, emit_final, got, want, f"step {t}")
        dones += int(got[2][1:3].sum())
        st_t, st_j = got[0], next_jax_state(env_id, got, want)
    if max_steps is not None:
        assert dones > 0


def step_close(env_id, jenv, tenv, st, act, rows, emit_final, got, want, tag):
    """SD and CP: the whole step to the JAX kernel's.  DR and PE: lane by
    lane, with the dribbler-face lanes held to the JAX XLA env."""
    if env_id in (DR, PE):
        dribbler_face_lanes(env_id, jenv, tenv, st, act, rows, emit_final, got, want, tag)
    else:
        assert_step_close(tenv.n_robots, got, want, tag)


def next_jax_state(env_id, got, want):
    """SD and CP: the JAX kernel goes on from its own state; DR and PE from
    the port's, so a dribbler-face lane does not carry over."""
    return jnp.asarray(got[0].numpy()) if env_id in (DR, PE) else want[0]


@pytest.mark.parametrize("env_id", [SD, CP, DR, PE])
def test_kernel_rng_mode_matches_jax_kernel(env_id):
    """The in-kernel-RNG stream, repacked as the JAX kernel's input rows,
    gives the JAX kernel's outputs; the key advances by one per step (DR,
    which draws nothing, too)."""
    jmake, _, wrapper, draw = TASKS[env_id]
    jenv, tenv = pair(env_id, max_steps=3)
    jstep = jmake(jenv, B, tile=B, interpret=True)
    key = philox.make_key(77, device="cpu")
    st_t = reset_packed(tenv, seed=5)
    st_j = jnp.asarray(st_t.numpy())
    rng = np.random.default_rng(3)
    for t in range(5):
        act = torch.from_numpy(rng.uniform(-1, 1, (tenv.action_size, B)).astype(np.float32))
        rows = draw(tenv, key.clone(), B)  # what the kernel draws
        want = jstep(st_j, jnp.asarray(act.numpy()), *(jnp.asarray(r.numpy()) for r in rows))
        step_before = int(key[2])
        got = wrapper(tenv, st_t, act, key=key)
        assert int(key[2]) == step_before + 1
        step_close(env_id, jenv, tenv, st_t, act, rows, False, got, want, f"step {t}")
        st_t, st_j = got[0], next_jax_state(env_id, got, want)


def test_sd_draw_slot_layout():
    """Ball, the six defenders' candidates, then theta: the slots the
    kernel draws (csrc/ssl_full.cu), word = slot % 4 of block slot // 4."""
    tenv = rsoccer_tpu_torch.make(SD)
    assert list(step_noise_spec(tenv)) == ["ball", "spawn", "theta"]
    key = philox.make_key(9, device="cpu")
    key[2] = (1 << 32) + 5
    u = philox.uniforms_from_words(philox.philox_words(key, 118, B))
    ball, spawn, theta = sf.sd_draw_step_rows(tenv, key, B)
    assert int(key[2]) == (1 << 32) + 6
    assert torch.equal(ball, u[:16]) and torch.equal(theta, u[112:118])
    for i in range(6):  # yellow i's block starts on a Philox block
        assert (16 + 16 * i) % 4 == 0
        assert torch.equal(spawn[16 * i:16 * i + 16], u[16 + 16 * i:32 + 16 * i])
    (enemy,) = sf.cp_draw_step_rows(rsoccer_tpu_torch.make(CP), philox.make_key(9, device="cpu"), B)
    assert torch.equal(enemy, philox.uniforms_from_words(
        philox.philox_words(philox.make_key(9, device="cpu"), 2, B)))


@pytest.mark.parametrize("env_id", [SD, CP, DR, PE])
def test_pack_unpack_equal_jax(env_id):
    """Packed rows -> structured state, infrared and wheel speeds
    recomputed as the JAX package's unpack does, DR's checkpoints and PE's
    stopped counter as int32; balls on robot faces."""
    jenv, tenv = pair(env_id)
    n = tenv.n_robots
    rng = np.random.default_rng(1)
    unpack_j, pack_j, _, unpack_t, pack_t, size = PACKING[env_id]
    assert size == {SD: 57, CP: 28, DR: 38, PE: 22}[env_id]
    arr = rng.uniform(-1, 1, (size, B)).astype(np.float32)
    arr[6 + 2 * n:6 + 3 * n] *= np.pi
    arr[6 + 6 * n] = rng.integers(0, 50, B)
    if env_id in (DR, PE):  # the checkpoint count, the stopped counter
        arr[7 + 6 * n] = rng.integers(0, 21, B)
    arr[2] = tenv.field.ball_radius
    r = rng.integers(0, n, B)  # put half the balls on robot r's kicker face
    face = np.arange(B) % 2 == 0
    th = arr[6 + 2 * n + r, np.arange(B)]
    arr[0] = np.where(face, arr[6 + r, np.arange(B)] + 0.1 * np.cos(th), arr[0])
    arr[1] = np.where(face, arr[6 + n + r, np.arange(B)] + 0.1 * np.sin(th), arr[1])
    want = unpack_j(jnp.asarray(arr), jenv)
    got = unpack_t(torch.from_numpy(arr), tenv)
    import jax

    for i, (g, w) in enumerate(zip(jax.tree.leaves(got), jax.tree.leaves(want))):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if w.dtype == np.bool_:
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(g, w, atol=5e-4 if g.ndim == 3 else 1e-6, err_msg=f"leaf {i}")
    assert got.world.robots.infrared.any()
    np.testing.assert_array_equal(pack_t(got).numpy(), np.asarray(pack_j(want)))


def test_kernel_param_struct_matches_cuda_source():
    """ctypes mirror of SslParams == the X-list in csrc/ssl_task.cuh (the
    header that ssl_full.cu and ssl_thread.cu share)."""
    src = open(os.path.join(PORT, "csrc", "ssl_task.cuh")).read()
    block = src[src.index("#define SSL_PARAMS(X)"): src.index("struct SslParams")]
    assert re.findall(r"X\((\w+)\)", block) == sf.PARAM_FIELDS
    for env_id in TASKS:
        assert sorted(sf.kernel_params(rsoccer_tpu_torch.make(env_id))) == sorted(sf.PARAM_FIELDS)
    pe = rsoccer_tpu_torch.make(PE)
    assert sf.kernel_params(pe)["max_kick_x"] == pe.max_kick_x == 5.0
    assert sf.kernel_params(pe)["ball_grad_scale"] == pe.ball_grad_scale


@pytest.mark.parametrize("env_id", [SD, CP, DR, PE])
def test_wrapper_dispatch_on_cpu(env_id):
    """On CPU the wrapper runs the plain version (never the kernel), with
    the Philox rows when given a key; it refuses ambiguous noise and other
    devices."""
    _, plain, wrapper, draw = TASKS[env_id]
    tenv = rsoccer_tpu_torch.make(env_id)
    st = reset_packed(tenv, seed=1)
    act = torch.zeros((tenv.action_size, B))
    key = philox.make_key(5, device="cpu")
    before = tracing.snapshot()
    got = wrapper(tenv, st, act, key=key.clone())
    want = plain(tenv, st, act, *draw(tenv, key.clone(), B))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tracing.launches(wrapper, since=before) == 0
    rows = draw(tenv, key.clone(), B)
    if rows:  # DR draws no noise: its only noise argument is the key
        with pytest.raises(ValueError):
            wrapper(tenv, st, act, *rows, key=key)
        with pytest.raises(ValueError):
            wrapper(tenv, st, act)
    with pytest.raises(NotImplementedError):
        wrapper(tenv, st.to("meta"), act.to("meta"), key=key)


@pytest.mark.parametrize("env_id", [SD, CP, DR, PE])
@pytest.mark.parametrize("fused_rng", ["input", "kernel"])
def test_fused_and_unfused_rollouts_agree(env_id, fused_rng):
    """The fused BatchedEnv (its plain version here) and the unfused one
    draw the same noise and give the same metrics and final obs; runs are
    deterministic per seed."""
    env = rsoccer_tpu_torch.make(env_id)
    env.max_episode_steps = 4  # episodes end inside the window
    fused = BatchedEnv(env, B, device="cpu", fused=True, fused_rng=fused_rng)
    twin = BatchedEnv(env, B, device="cpu")
    c_f, m_f = R.make_rollout_fn(fused, 10)(R.init_carry(fused, seed=3))
    c_t, m_t = R.make_rollout_fn(twin, 10)(R.init_carry(twin, seed=3))
    assert int(m_f.episodes) > 0 and int(m_f.episodes) == int(m_t.episodes)
    for a, b in zip(m_f, m_t):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    torch.testing.assert_close(c_f.obs, c_t.obs, rtol=0, atol=ATOL)
    torch.testing.assert_close(c_f.state, PACKING[env_id][4](c_t.state), rtol=0, atol=ATOL)
    c_2, m_2 = R.make_rollout_fn(fused, 10)(R.init_carry(fused, seed=3))
    assert torch.equal(c_f.state, c_2.state) and all(torch.equal(a, b) for a, b in zip(m_f, m_2))
    c_3, _ = R.make_rollout_fn(fused, 10)(R.init_carry(fused, seed=4))
    assert not torch.equal(c_f.state, c_3.state)
    up = fused.unpack_state(c_f.state)
    assert type(up) is type(c_t.state) and up.steps.shape == (B,)
    if env_id != DR:
        assert up.shaping.shape == (len(PACKING[env_id][2]), B)


def test_fused_refuses_training_extensions_and_other_types():
    # aim_shaping too, which the JAX package's fused guard lets through
    for env_id, kw in ((SD, {"curriculum": True}), (SD, {"terminal_penalty": 1.0}),
                       (DR, {"curriculum": True}), (PE, {"curriculum": True}),
                       (PE, {"catch_scale": 2.0}), (PE, {"aim_shaping": 0.5})):
        with pytest.raises(ValueError, match="training-time"):
            BatchedEnv(rsoccer_tpu_torch.make(env_id, **kw), 8, device="cpu", fused=True)
        BatchedEnv(rsoccer_tpu_torch.make(env_id, **kw), 8, device="cpu")  # unfused is fine

    class Tweaked(SSLStaticDefendersEnv):
        pass

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedEnv(Tweaked(), 8, device="cpu", fused=True)


@pytest.mark.parametrize("env_id", ["VSS-v0", SD, CP, DR, PE])
def test_entry_points_default_to_the_card(env_id):
    """make_vec and BatchedEnv are on the card unless asked for the CPU;
    without a card, reset raises instead of running on the CPU."""
    benv = rsoccer_tpu_torch.make_vec(env_id, 8, fused=True)
    assert benv.device.type == "cuda"
    assert BatchedEnv(rsoccer_tpu_torch.make(env_id), 8).device.type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present; the defaults run for real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benv.reset(philox.make_key(0, device="cpu"))
    with pytest.raises((RuntimeError, AssertionError)):  # torch's own "no CUDA"
        R.init_carry(benv, seed=0)
    with pytest.raises((RuntimeError, AssertionError)):
        philox.make_key(0)
    cpu = rsoccer_tpu_torch.make_vec(env_id, 8, device="cpu", fused=True)
    with pytest.raises(ValueError, match="key is on"):
        cpu.reset(philox.make_key(0, device="meta"))


@pytest.mark.parametrize("delta", [-1, 0, 1, 4096])
@pytest.mark.parametrize("entry", ["ssl_sd_full_step", "ssl_dr_full_step"])
def test_route_at_the_crossover(entry, delta):
    """SD and DR run their 8-lane group kernels up to GROUP_MAX_ENVS and
    their one-thread kernels above it."""
    want = "group" if delta <= 0 else "thread"
    assert sf.route(entry, sf.GROUP_MAX_ENVS[entry] + delta) == want


@pytest.mark.parametrize("batch", [1, 8191, 8192, 16384, 131072])
@pytest.mark.parametrize("entry", ["ssl_cp_full_step", "ssl_pe_full_step"])
def test_route_runs_cp_and_pe_on_one_thread(entry, batch):
    """CP and PE have one kernel, one env per thread, behind their own C
    entry at every batch."""
    assert sf.route(entry, batch) == "thread"
    assert sf.routed_entry(entry, batch) == entry


@pytest.mark.parametrize("entry", ["ssl_sd_full_step", "ssl_dr_full_step"])
def test_routed_entry_of_sd_and_dr(entry):
    """SD's and DR's group kernel is behind their C entry, their one-thread
    kernel behind ``_one_thread``."""
    assert sf.routed_entry(entry, sf.GROUP_MAX_ENVS[entry]) == entry
    assert sf.routed_entry(entry, sf.GROUP_MAX_ENVS[entry] + 1) == entry + "_one_thread"


def test_route_constants():
    """The crossovers the card measured (PERF.md, section 6), SD's and
    DR's own: the main path's 8192 envs run SD's group kernel and DR's
    one-thread kernel; the four fused steps' C entries route, and no other
    name does."""
    assert sf.GROUP_MAX_ENVS == {"ssl_sd_full_step": 8448, "ssl_dr_full_step": 4096}
    assert sf.route("ssl_sd_full_step", 8192) == "group" and sf.route("ssl_dr_full_step", 8192) == "thread"
    assert set(sf.ENTRIES) == {"ssl_sd_full_step", "ssl_cp_full_step", "ssl_dr_full_step",
                               "ssl_pe_full_step"}
    with pytest.raises(ValueError, match="no fused SSL step"):
        sf.route("ssl_xx_full_step", 8192)


@pytest.mark.parametrize("env_id", [SD, CP, DR, PE])
def test_cpu_steps_count_no_entry(env_id):
    """The plain version on the CPU launches nothing: no C entry counts."""
    _, _, wrapper, draw = TASKS[env_id]
    tenv = rsoccer_tpu_torch.make(env_id)
    before = tracing.snapshot()
    wrapper(tenv, reset_packed(tenv, seed=2), torch.zeros((tenv.action_size, B)),
            key=philox.make_key(6, device="cpu"))
    assert tracing.entry_launches(wrapper, since=before) == {}
