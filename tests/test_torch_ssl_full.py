"""The fused SSL steps' plain versions vs the JAX package's Pallas kernels
(interpret mode) for SSLStaticDefenders-v0 and SSLContestedPossession-v0,
their kernel-RNG mode through the Philox rows, the packed layout, the
kernels' parameter struct, the fused BatchedEnv and rollout, and the
port's default device."""

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

torch.set_num_threads(1)

B = 16
ATOL = 5e-5
PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rsoccer_tpu_torch")
SD, CP = "SSLStaticDefenders-v0", "SSLContestedPossession-v0"
TASKS = {  # env id -> (JAX kernel factory, port plain, port wrapper, port draw)
    SD: (jpsf.make_pallas_sd_full_step, sf.sd_full_step_plain, sf.sd_full_step, sf.sd_draw_step_rows),
    CP: (jpsf.make_pallas_cp_full_step, sf.cp_full_step_plain, sf.cp_full_step, sf.cp_draw_step_rows),
}


def pair(env_id, max_steps=None):
    jenv, tenv = rsoccer_tpu.make(env_id), rsoccer_tpu_torch.make(env_id)
    if max_steps is not None:
        jenv.max_episode_steps = tenv.max_episode_steps = max_steps
    return jenv, tenv


def reset_packed(tenv, seed):
    return BatchedEnv(tenv, B, device="cpu", fused=True).reset(philox.make_key(seed, device="cpu"))[0]


def np_rows(rng, tenv):
    """Uniform noise rows of the step, as the kernel takes them."""
    rows = philox.uniforms_from_words(philox.philox_words(
        philox.make_key(int(rng.integers(1 << 30)), device="cpu"),
        sum(int(np.prod(s)) for s, _ in step_noise_spec(tenv).values()), B))
    noise = {}
    off = 0
    for name, (shape, _) in step_noise_spec(tenv).items():
        n = int(np.prod(shape))
        noise[name] = rows[off:off + n].reshape(shape + (B,))
        off += n
    return sf.sd_noise_rows(tenv, noise) if "ball" in noise else sf.cp_noise_rows(tenv, noise)


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
    [(SD, False, None), (SD, True, 3), (CP, False, 3), (CP, True, None)],
    ids=["SD-obs-limit1000", "SD-final_obs-limit3", "CP-obs-limit3", "CP-final_obs-limit1200"],
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
        act = torch.from_numpy(rng.uniform(-1, 1, (5, B)).astype(np.float32))
        rows = np_rows(rng, tenv)
        want = jstep(st_j, jnp.asarray(act.numpy()), *(jnp.asarray(r.numpy()) for r in rows))
        got = plain(tenv, st_t, act, *rows, emit_final)
        assert got[1].shape == (tenv.obs_size * (2 if emit_final else 1), B)
        assert_step_close(tenv.n_robots, got, want, f"step {t}")
        dones += int(got[2][1:3].sum())
        st_t, st_j = got[0], want[0]
    if max_steps is not None:
        assert dones > 0


@pytest.mark.parametrize("env_id", [SD, CP])
def test_kernel_rng_mode_matches_jax_kernel(env_id):
    """The in-kernel-RNG stream, repacked as the JAX kernel's input rows,
    gives the JAX kernel's outputs; the key advances by one per step."""
    jmake, _, wrapper, draw = TASKS[env_id]
    jenv, tenv = pair(env_id, max_steps=3)
    jstep = jmake(jenv, B, tile=B, interpret=True)
    key = philox.make_key(77, device="cpu")
    st_t = reset_packed(tenv, seed=5)
    st_j = jnp.asarray(st_t.numpy())
    rng = np.random.default_rng(3)
    for t in range(5):
        act = torch.from_numpy(rng.uniform(-1, 1, (5, B)).astype(np.float32))
        rows = draw(tenv, key.clone(), B)  # what the kernel draws
        want = jstep(st_j, jnp.asarray(act.numpy()), *(jnp.asarray(r.numpy()) for r in rows))
        step_before = int(key[2])
        got = wrapper(tenv, st_t, act, key=key)
        assert int(key[2]) == step_before + 1
        assert_step_close(tenv.n_robots, got, want, f"step {t}")
        st_t, st_j = got[0], want[0]


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


@pytest.mark.parametrize("env_id", [SD, CP])
def test_pack_unpack_equal_jax(env_id):
    """Packed rows -> structured state, infrared and wheel speeds
    recomputed as the JAX package's unpack does; balls on robot faces."""
    jenv, tenv = pair(env_id)
    n = tenv.n_robots
    rng = np.random.default_rng(1)
    size = sf.sd_state_size() if env_id == SD else sf.cp_state_size()
    arr = rng.uniform(-1, 1, (size, B)).astype(np.float32)
    arr[6 + 2 * n:6 + 3 * n] *= np.pi
    arr[6 + 6 * n] = rng.integers(0, 50, B)
    arr[2] = tenv.field.ball_radius
    r = rng.integers(0, n, B)  # put half the balls on robot r's kicker face
    face = np.arange(B) % 2 == 0
    th = arr[6 + 2 * n + r, np.arange(B)]
    arr[0] = np.where(face, arr[6 + r, np.arange(B)] + 0.1 * np.cos(th), arr[0])
    arr[1] = np.where(face, arr[6 + n + r, np.arange(B)] + 0.1 * np.sin(th), arr[1])
    unpack_j = jpsf.unpack_sd_state if env_id == SD else jpsf.unpack_cp_state
    want = unpack_j(jnp.asarray(arr), jenv)
    got = (sf.unpack_sd_state if env_id == SD else sf.unpack_cp_state)(torch.from_numpy(arr), tenv)
    import jax

    for i, (g, w) in enumerate(zip(jax.tree.leaves(got), jax.tree.leaves(want))):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if w.dtype == np.bool_:
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(g, w, atol=5e-4 if g.ndim == 3 else 1e-6, err_msg=f"leaf {i}")
    assert got.world.robots.infrared.any()
    np.testing.assert_array_equal(sf.pack_ssl_state(got).numpy(), np.asarray(jpsf.pack_sd_state(want)))


def test_kernel_param_struct_matches_cuda_source():
    """ctypes mirror of SslParams == the X-list in csrc/ssl_full.cu."""
    src = open(os.path.join(PORT, "csrc", "ssl_full.cu")).read()
    block = src[src.index("#define SSL_PARAMS(X)"): src.index("struct SslParams")]
    assert re.findall(r"X\((\w+)\)", block) == sf.PARAM_FIELDS
    for env_id in (SD, CP):
        assert sorted(sf.kernel_params(rsoccer_tpu_torch.make(env_id))) == sorted(sf.PARAM_FIELDS)


@pytest.mark.parametrize("env_id", [SD, CP])
def test_wrapper_dispatch_on_cpu(env_id):
    """On CPU the wrapper runs the plain version (never the kernel), with
    the Philox rows when given a key; it refuses ambiguous noise and other
    devices."""
    _, plain, wrapper, draw = TASKS[env_id]
    tenv = rsoccer_tpu_torch.make(env_id)
    st = reset_packed(tenv, seed=1)
    act = torch.zeros((5, B))
    key = philox.make_key(5, device="cpu")
    launches = wrapper.launches
    got = wrapper(tenv, st, act, key=key.clone())
    want = plain(tenv, st, act, *draw(tenv, key.clone(), B))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert wrapper.launches == launches
    rows = draw(tenv, key.clone(), B)
    with pytest.raises(ValueError):
        wrapper(tenv, st, act, *rows, key=key)
    with pytest.raises(ValueError):
        wrapper(tenv, st, act)
    with pytest.raises(NotImplementedError):
        wrapper(tenv, st.to("meta"), act.to("meta"), key=key)


@pytest.mark.parametrize("env_id", [SD, CP])
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
    torch.testing.assert_close(c_f.state, sf.pack_ssl_state(c_t.state), rtol=0, atol=ATOL)
    c_2, m_2 = R.make_rollout_fn(fused, 10)(R.init_carry(fused, seed=3))
    assert torch.equal(c_f.state, c_2.state) and all(torch.equal(a, b) for a, b in zip(m_f, m_2))
    c_3, _ = R.make_rollout_fn(fused, 10)(R.init_carry(fused, seed=4))
    assert not torch.equal(c_f.state, c_3.state)
    up = fused.unpack_state(c_f.state)
    assert up.shaping.shape == (len(sf.SD_KEYS if env_id == SD else sf.CP_KEYS), B)


def test_fused_refuses_training_extensions_and_other_types():
    for kw in ({"curriculum": True}, {"terminal_penalty": 1.0}):
        with pytest.raises(ValueError, match="training-time"):
            BatchedEnv(SSLStaticDefendersEnv(**kw), 8, device="cpu", fused=True)
        BatchedEnv(SSLStaticDefendersEnv(**kw), 8, device="cpu")  # unfused is fine

    class Tweaked(SSLStaticDefendersEnv):
        pass

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedEnv(Tweaked(), 8, device="cpu", fused=True)


@pytest.mark.parametrize("env_id", ["VSS-v0", SD, CP])
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
