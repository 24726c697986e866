"""The CUDA kernels vs their plain PyTorch versions, on the card.

Every test needs an NVIDIA card and nvcc: it is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is false.  This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import ctypes
import dataclasses
import math

import pytest
import torch

import rsoccer_tpu_torch
from rsoccer_tpu_torch.batch import rollout as R
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.core.state import tree_map
from rsoccer_tpu_torch.ops import ssl_full as sf
from rsoccer_tpu_torch.ops import vss_full as vf
from rsoccer_tpu_torch.ops import vss_physics as vp
from rsoccer_tpu_torch.ops.philox import make_key, philox_words
from rsoccer_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

B = 256
ATOL = 5e-5
RAGGED = [1, 37, 8191, 8193]  # batches that leave the last 32-env block part empty
# VSS-v0 beyond 3v3 and the Taylor bound: what the 16-lane group kernel
# (5v5), the one-thread kernel (1v0, 2v5) and, at 3v3, the group kernel's
# exact-trig policy run
VSS_CONFIGS = {
    "5v5": dict(field_type=1, n_robots_blue=5, n_robots_yellow=5),
    "1v0": dict(n_robots_blue=1, n_robots_yellow=0),
    "3v3_dt0.2": dict(time_step=0.2),
    "2v5_dt0.1": dict(n_robots_blue=2, n_robots_yellow=5, time_step=0.1),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def assert_step_close(env, got, want, tag):
    n = env.n_robots
    st, obs, aux = got
    w_st, w_obs, w_aux = want
    th = slice(6 + 2 * n, 6 + 3 * n)
    d = (st - w_st).abs()
    d[th] = (torch.remainder(st[th] - w_st[th] + math.pi, 2 * math.pi) - math.pi).abs()
    steps_row = 6 + 6 * n
    assert float(d[:steps_row].max()) <= ATOL, tag
    assert float(d[steps_row + 1:].max()) <= ATOL, tag
    assert torch.equal(st[steps_row], w_st[steps_row]), tag
    assert float((obs - w_obs).abs().max()) <= ATOL, tag
    assert float((aux[0] - w_aux[0]).abs().max()) <= ATOL, tag
    assert torch.equal(aux[1:3], w_aux[1:3]), tag
    if aux.shape[0] > 3:  # DR has no info rows
        assert float((aux[3:] - w_aux[3:]).abs().max()) <= ATOL, tag


def check_vss_steps(env, st_k, key, rng_mode, emit_final, gen, n_steps=5):
    """``n_steps`` fused steps, kernel and plain each on their own
    trajectory from ``st_k``; returns the dones seen."""
    b = st_k.shape[-1]
    st_p, key_p = st_k.clone(), key.clone()
    before = tracing.snapshot()
    dones = 0
    for t in range(n_steps):
        act = torch.rand((2, b), generator=gen, device=st_k.device) * 2 - 1
        if rng_mode == "kernel":
            got = vf.vss_full_step(env, st_k, act, key=key, emit_final=emit_final)
            rows = vf.draw_step_rows(env, key_p, b)
        else:
            rows = vf.draw_step_rows(env, key, b)
            got = vf.vss_full_step(env, st_k, act, *rows, emit_final=emit_final)
        want = vf.vss_full_step_plain(env, st_p, act, *rows, emit_final)
        torch.cuda.synchronize()
        assert_step_close(env, got, want, f"step {t}")
        dones += int(got[2][1:3].sum())
        st_k, st_p = got[0], want[0]
    assert tracing.launches(vf.vss_full_step, since=before) == n_steps
    if rng_mode == "kernel":  # the kernel advanced its key as draw_noise did
        assert torch.equal(key, key_p)
    return dones


@pytest.mark.parametrize("rng_mode", ["input", "kernel"])
@pytest.mark.parametrize("emit_final", [False, True], ids=["obs", "final_obs"])
@pytest.mark.parametrize("max_steps", [None, 3], ids=["limit1200", "limit3"])
def test_kernel_matches_plain(cuda, rng_mode, emit_final, max_steps):
    env = rsoccer_tpu_torch.make("VSS-v0")
    if max_steps is not None:
        env.max_episode_steps = max_steps
    key = make_key(1, device=cuda)
    st_k, _ = BatchedEnv(env, B, device=cuda, fused=True).reset(key)
    check_vss_steps(env, st_k, key, rng_mode, emit_final, torch.Generator(device=cuda).manual_seed(2))


def stagger(st, n=6):
    """Step counters staggered over the lanes, so that envs of one warp fall
    due on different steps (partial reset masks)."""
    st[6 + 6 * n] = (torch.arange(st.shape[-1], device=st.device) % 3).to(st.dtype)
    return st


@pytest.mark.parametrize("batch", RAGGED)
@pytest.mark.parametrize("rng_mode", ["input", "kernel"])
@pytest.mark.parametrize("emit_final", [False, True], ids=["obs", "final_obs"])
def test_kernel_matches_plain_ragged(cuda, batch, rng_mode, emit_final):
    """Batches that leave a block part empty, through auto-resets that fall
    on different steps in one warp."""
    env = rsoccer_tpu_torch.make("VSS-v0")
    env.max_episode_steps = 3
    key = make_key(4, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    st_k, _ = BatchedEnv(env, batch, device=cuda, fused=True).reset(key)
    dones = check_vss_steps(env, stagger(st_k), key, rng_mode, emit_final, gen)
    assert dones >= batch  # every env reset at least once


@pytest.mark.parametrize("env_base", [0, 3 * B])
def test_philox_words_bit_equal(cuda, env_base):
    lib = vf._library()
    key = make_key(99, stream=2, device=cuda)
    key[2] = (3 << 32) + 1
    n_blk = 36
    out = torch.empty((4 * n_blk, B), dtype=torch.int32, device=cuda)
    assert lib.philox_words(key.data_ptr(), out.data_ptr(), n_blk, env_base, B,
                            torch.cuda.current_stream().cuda_stream) == 0
    assert torch.equal(out.to(torch.int64) & 0xFFFFFFFF, philox_words(key, 4 * n_blk, B, env_base=env_base))


def test_main_path_goes_through_the_kernel(cuda):
    benv = BatchedEnv(rsoccer_tpu_torch.make("VSS-v0"), B, device=cuda, fused=True,
                      fused_rng="kernel")
    carry = R.init_carry(benv, seed=0)
    before = tracing.snapshot()
    carry, ms = R.make_rollout_fn(benv, 20)(carry)
    assert tracing.launches(vf.vss_full_step, since=before) == 20
    assert bool(torch.isfinite(carry.obs).all())
    assert bool((carry.obs.abs() <= torch.tensor(1.2)).all())


def test_bad_operands_raise(cuda):
    env = rsoccer_tpu_torch.make("VSS-v0")
    st = torch.zeros((vf.state_size(6), B), device=cuda)
    key = make_key(0, device=cuda)
    with pytest.raises(ValueError):
        vf.vss_full_step(env, st, torch.zeros((3, B), device=cuda), key=key)
    with pytest.raises(ValueError):
        vf.vss_full_step(env, st, torch.zeros((2, B), device=cuda), key=key.cpu())
    odd = rsoccer_tpu_torch.make("VSS-v0", n_robots_blue=6, n_robots_yellow=6)  # past 5v5
    with pytest.raises(NotImplementedError):
        vf.vss_full_step(odd, torch.zeros((vf.state_size(odd.n_robots), B), device=cuda),
                         torch.zeros((2, B), device=cuda), key=key)


@pytest.mark.parametrize("rng_mode", ["input", "kernel"])
@pytest.mark.parametrize("emit_final", [False, True], ids=["obs", "final_obs"])
@pytest.mark.parametrize("batch", [B, 8191])
@pytest.mark.parametrize("config", list(VSS_CONFIGS))
def test_kernel_matches_plain_configs(cuda, config, batch, rng_mode, emit_final):
    """VSS-v0 at other team sizes and beyond the Taylor bound (5v5 on the
    16-lane group kernel, 1v0 and 2v5 on the one-thread kernel, 3v3 on the
    group kernel's exact-trig policy), through auto-resets that fall on
    different steps in one warp."""
    env = rsoccer_tpu_torch.make("VSS-v0", **VSS_CONFIGS[config])
    env.max_episode_steps = 3
    key = make_key(8, device=cuda)
    st_k, _ = BatchedEnv(env, batch, device=cuda, fused=True).reset(key)
    dones = check_vss_steps(env, stagger(st_k, env.n_robots), key, rng_mode, emit_final,
                            torch.Generator(device=cuda).manual_seed(9))
    assert dones >= batch


def vss_entry(entry, env, st, act, rows, key, emit_final):
    """The outputs of the C entry ``entry`` (``vss_full_step``,
    ``vss_full_step_one_thread`` or ``vss_full_step_one_thread_capped``) on
    these operands; the key is not advanced."""
    b = st.shape[-1]
    outs = (torch.full_like(st, float("nan")),
            torch.full((env.obs_size * (2 if emit_final else 1), b), float("nan"), device=st.device),
            torch.full((vf.N_AUX, b), float("nan"), device=st.device))
    rng = key is not None
    ou, sp, th = (None, None, None) if rng else (r.data_ptr() for r in rows)
    err = getattr(vf._library(), entry)(
        env.n_blue, env.n_yellow, int(emit_final), int(rng), int(not vf.taylor_rotation_holds(env)),
        ctypes.byref(vf._params_struct(env)), st.data_ptr(), act.data_ptr(), ou, sp, th,
        key.data_ptr() if rng else None, *(t.data_ptr() for t in outs), 0, b,  # env_base 0
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, entry
    torch.cuda.synchronize()
    return outs


def bit_equal(got, want):
    """Every output equal bit for bit (a -0 against a +0 counts)."""
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))


# team size -> (env kwargs, batch) of the group kernels' bit-for-bit checks:
# 3v3 on 8 lanes, 5v5 on 16 (also at a ragged batch: the last 16-env block
# part empty)
GROUP_TEAMS = {
    "3v3": ({}, B),
    "5v5": (VSS_CONFIGS["5v5"], B),
    "5v5_ragged": (VSS_CONFIGS["5v5"], 8191),
    "3v3_ragged": ({}, 8191),  # B % 4 != 0, the last 64-env block of the one-thread kernel part empty
    "5v5_ragged_1001": (VSS_CONFIGS["5v5"], 1001),
}


@pytest.mark.parametrize("team", list(GROUP_TEAMS))
@pytest.mark.parametrize("time_step", [0.025, 0.1], ids=["taylor", "exact_trig"])
@pytest.mark.parametrize("rng_mode", ["input", "kernel"])
@pytest.mark.parametrize("emit_final", [False, True], ids=["obs", "final_obs"])
def test_one_thread_kernel_bit_equal_to_group_kernel(cuda, team, time_step, rng_mode, emit_final):
    """At 3v3 and 5v5 the one-thread kernel gives the group kernel's bits,
    through auto-resets, in both trig policies."""
    kwargs, batch = GROUP_TEAMS[team]
    env = rsoccer_tpu_torch.make("VSS-v0", **kwargs, time_step=time_step)
    env.max_episode_steps = 3
    key = make_key(2, device=cuda)
    st, _ = BatchedEnv(env, batch, device=cuda, fused=True).reset(key)
    st = stagger(st, env.n_robots)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for t in range(5):
        act = torch.rand((2, batch), generator=gen, device=cuda) * 2 - 1
        rows = vf.draw_step_rows(env, key.clone(), batch)
        k = key if rng_mode == "kernel" else None
        group = vss_entry("vss_full_step", env, st, act, rows, k, emit_final)
        thread = vss_entry("vss_full_step_one_thread", env, st, act, rows, k, emit_final)
        assert bit_equal(thread, group), f"step {t}"
        if env.n_robots in vf.THREAD_CAPPED_ROBOTS:  # the register-capped variant too
            assert bit_equal(vss_entry("vss_full_step_one_thread_capped", env, st, act, rows, k, emit_final),
                             group), f"step {t}"
        key[2:].add_(1)
        st = group[0]


# the one-thread kernels at ragged batches: B % 4 != 0 and B not a multiple
# of the 64-thread block, each through its C entry whatever the route
THREAD_TEAMS = {
    "1v0": VSS_CONFIGS["1v0"],
    "2v2": dict(n_robots_blue=2, n_robots_yellow=2),
    "3v3": {},
    "5v5": VSS_CONFIGS["5v5"],
    "5v5_dt0.1": dict(VSS_CONFIGS["5v5"], time_step=0.1),
}


@pytest.mark.parametrize("batch", [37, 8191, 16385])
@pytest.mark.parametrize("team", list(THREAD_TEAMS))
@pytest.mark.parametrize("rng_mode", ["input", "kernel"])
@pytest.mark.parametrize("emit_final", [False, True], ids=["obs", "final_obs"])
def test_one_thread_kernel_matches_plain_ragged(cuda, team, batch, rng_mode, emit_final):
    """The one-thread kernel (and, at 7-10 robots, its capped variant, bit
    for bit the same) against the plain version through auto-resets that
    fall on different steps in one warp."""
    env = rsoccer_tpu_torch.make("VSS-v0", **THREAD_TEAMS[team])
    env.max_episode_steps = 3
    key = make_key(5, device=cuda)
    st, _ = BatchedEnv(env, batch, device=cuda, fused=True).reset(key)
    st = stagger(st, env.n_robots)
    gen = torch.Generator(device=cuda).manual_seed(7)
    dones = 0
    for t in range(5):
        act = torch.rand((2, batch), generator=gen, device=cuda) * 2 - 1
        rows = vf.draw_step_rows(env, key.clone(), batch)
        k = key if rng_mode == "kernel" else None
        got = vss_entry("vss_full_step_one_thread", env, st, act, rows, k, emit_final)
        if env.n_robots in vf.THREAD_CAPPED_ROBOTS:
            assert bit_equal(vss_entry("vss_full_step_one_thread_capped", env, st, act, rows, k, emit_final), got)
        want = vf.vss_full_step_plain(env, st, act, *rows, emit_final)
        assert_step_close(env, got, want, f"step {t}")
        dones += int(got[2][1:3].sum())
        key[2:].add_(1)
        st = got[0]
    assert dones >= batch


@pytest.mark.parametrize("batch", [37, 8191, 16385])
@pytest.mark.parametrize("n", [1, 6, 10])
def test_one_thread_physics_kernel_matches_plain_ragged(cuda, n, batch):
    """K2's one-thread kernel (at N = 10 also its capped variant, bit for
    bit the same) against the plain version at ragged batches."""
    env = rsoccer_tpu_torch.make("VSS-v0", **{1: VSS_CONFIGS["1v0"], 6: {}, 10: VSS_CONFIGS["5v5"]}[n])
    gen = torch.Generator(device=cuda).manual_seed(11)
    lib = vp._library()
    for trial in range(3):
        rb, ball, cmd = random_vss_arrays(gen, cuda, n=n, batch=batch)
        outs = {}
        for entry in ("vss_physics_step_one_thread",) + (
                ("vss_physics_step_one_thread_capped",) if n in vp.THREAD_CAPPED_ROBOTS else ()):
            outs[entry] = (torch.full_like(rb, float("nan")), torch.full_like(ball, float("nan")))
            assert getattr(lib, entry)(
                ctypes.byref(vp._params_struct(env)), rb.data_ptr(), ball.data_ptr(), cmd.data_ptr(),
                *(t.data_ptr() for t in outs[entry]), n, batch, torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        k_rb, k_ball = outs["vss_physics_step_one_thread"]
        assert all(bit_equal(o, (k_rb, k_ball)) for o in outs.values()), trial
        p_rb, p_ball = vp.vss_physics_plain(env, rb, ball, cmd)
        d_th = (torch.remainder(k_rb[2] - p_rb[2] + math.pi, 2 * math.pi) - math.pi).abs()
        assert float(d_th.max()) <= ATOL, trial
        assert float((k_rb[[0, 1, 3, 4, 5]] - p_rb[[0, 1, 3, 4, 5]]).abs().max()) <= ATOL, trial
        assert float((k_ball - p_ball).abs().max()) <= ATOL, trial


def test_capped_entries_refuse_other_team_sizes(cuda):
    """The capped variants exist for 7-10 robots only: another team size is
    refused (cudaErrorInvalidValue), never run on another kernel."""
    env = rsoccer_tpu_torch.make("VSS-v0")
    st, _ = BatchedEnv(env, B, device=cuda, fused=True).reset(make_key(1, device=cuda))
    with pytest.raises(AssertionError, match="vss_full_step_one_thread_capped"):
        vss_entry("vss_full_step_one_thread_capped", env, st, torch.zeros((2, B), device=cuda), None,
                  make_key(2, device=cuda), False)


SSL = {  # env id -> (wrapper, plain, draw)
    "SSLStaticDefenders-v0": (sf.sd_full_step, sf.sd_full_step_plain, sf.sd_draw_step_rows),
    "SSLContestedPossession-v0": (sf.cp_full_step, sf.cp_full_step_plain, sf.cp_draw_step_rows),
    "SSLDribbling-v0": (sf.dr_full_step, sf.dr_full_step_plain, sf.dr_draw_step_rows),
    "SSLPassEndurance-v0": (sf.pe_full_step, sf.pe_full_step_plain, sf.pe_draw_step_rows),
}
WRAPPERS = [vf.vss_full_step, vp.vss_physics] + [w for w, _, _ in SSL.values()]
ENTRY = {  # env id -> the fused step's C entry
    "SSLStaticDefenders-v0": "ssl_sd_full_step", "SSLContestedPossession-v0": "ssl_cp_full_step",
    "SSLDribbling-v0": "ssl_dr_full_step", "SSLPassEndurance-v0": "ssl_pe_full_step",
}


def launch_counts():
    return [tracing.launches(w) for w in WRAPPERS]


def check_ssl_steps(env, wrapper, plain, draw, st_k, key, rng_mode, emit_final, gen, n_steps=5):
    """``n_steps`` fused SSL steps, kernel and plain each on their own
    trajectory from ``st_k``; returns the dones seen."""
    b = st_k.shape[-1]
    st_p, key_p = st_k.clone(), key.clone()
    before = tracing.snapshot()
    dones = 0
    for t in range(n_steps):
        act = torch.rand((env.action_size, b), generator=gen, device=st_k.device) * 2 - 1
        if rng_mode == "kernel":
            got = wrapper(env, st_k, act, key=key, emit_final=emit_final)
            rows = draw(env, key_p, b)
        else:
            rows = draw(env, key, b)
            got = wrapper(env, st_k, act, *rows, emit_final=emit_final)
        want = plain(env, st_p, act, *rows, emit_final)
        torch.cuda.synchronize()
        assert_step_close(env, got, want, f"step {t}")
        dones += int(got[2][1:3].sum())
        st_k, st_p = got[0], want[0]
    assert tracing.launches(wrapper, since=before) == n_steps
    if rng_mode == "kernel":
        assert torch.equal(key, key_p)
    return dones


@pytest.mark.parametrize("rng_mode", ["input", "kernel"])
@pytest.mark.parametrize("emit_final", [False, True], ids=["obs", "final_obs"])
@pytest.mark.parametrize("max_steps", [None, 3], ids=["limit_default", "limit3"])
@pytest.mark.parametrize("env_id", list(SSL))
def test_ssl_kernel_matches_plain(cuda, env_id, rng_mode, emit_final, max_steps):
    wrapper, plain, draw = SSL[env_id]
    env = rsoccer_tpu_torch.make(env_id)
    if max_steps is not None:
        env.max_episode_steps = max_steps
    key = make_key(1, device=cuda)
    st_k, _ = BatchedEnv(env, B, device=cuda, fused=True).reset(key)
    dones = check_ssl_steps(env, wrapper, plain, draw, st_k, key, rng_mode, emit_final,
                            torch.Generator(device=cuda).manual_seed(2))
    if max_steps is not None:  # auto-resets inside the window
        assert dones > 0


@pytest.mark.parametrize("batch", RAGGED)
@pytest.mark.parametrize("rng_mode", ["input", "kernel"])
@pytest.mark.parametrize("emit_final", [False, True], ids=["obs", "final_obs"])
@pytest.mark.parametrize("env_id", ["SSLStaticDefenders-v0", "SSLDribbling-v0"])
def test_ssl_group_kernel_matches_plain_ragged(cuda, env_id, batch, rng_mode, emit_final):
    """The SD and DR steps on 8 lanes per env at batches that leave a block
    part empty, through auto-resets that fall on different steps in one
    warp."""
    wrapper, plain, draw = SSL[env_id]
    top = sf.GROUP_MAX_ENVS[ENTRY[env_id]]
    if batch > top:  # DR's crossover lies below SD's: the same raggedness below it
        batch -= max(sf.GROUP_MAX_ENVS.values()) - top
    before = tracing.snapshot()
    env = rsoccer_tpu_torch.make(env_id)
    env.max_episode_steps = 3
    key = make_key(4, device=cuda)
    st_k, _ = BatchedEnv(env, batch, device=cuda, fused=True).reset(key)
    dones = check_ssl_steps(env, wrapper, plain, draw, stagger(st_k, env.n_robots), key, rng_mode, emit_final,
                            torch.Generator(device=cuda).manual_seed(6))
    assert dones >= batch  # every env reset at least once
    assert tracing.entry_launches(wrapper, since=before) == {ENTRY[env_id]: 5}


@pytest.mark.parametrize("rng_mode", ["input", "kernel"])
@pytest.mark.parametrize("emit_final", [False, True], ids=["obs", "final_obs"])
@pytest.mark.parametrize("env_id", list(SSL))
def test_ssl_one_thread_kernel_matches_plain(cuda, env_id, rng_mode, emit_final):
    """Above GROUP_MAX_ENVS' crossovers every SSL wrapper launches its one-thread
    kernel (CP and PE at every batch): held to the plain versions there, at
    a batch that leaves a block part empty, through auto-resets."""
    wrapper, plain, draw = SSL[env_id]
    before = tracing.snapshot()
    env = rsoccer_tpu_torch.make(env_id)
    env.max_episode_steps = 3
    batch = max(sf.GROUP_MAX_ENVS.values()) + 1
    key = make_key(5, device=cuda)
    st_k, _ = BatchedEnv(env, batch, device=cuda, fused=True).reset(key)
    dones = check_ssl_steps(env, wrapper, plain, draw, stagger(st_k, env.n_robots), key, rng_mode, emit_final,
                            torch.Generator(device=cuda).manual_seed(7))
    assert dones >= batch
    assert tracing.entry_launches(wrapper, since=before) == {sf.routed_entry(ENTRY[env_id], batch): 5}


def ssl_entry(entry, env, st, act, rows, key, emit_final):
    """The outputs of the SSL C entry ``entry`` (SD's or DR's group or
    one-thread entry) on these operands; the key is not advanced."""
    b = st.shape[-1]
    outs = (torch.full_like(st, float("nan")),
            torch.full((env.obs_size * (2 if emit_final else 1), b), float("nan"), device=st.device),
            torch.full((3 + (len(sf.SD_KEYS) if entry.startswith("ssl_sd") else 0), b), float("nan"),
                       device=st.device))
    rng = key is not None
    noise, base = (), ()
    if entry.startswith("ssl_sd"):  # DR draws nothing: no noise pointers, no env_base
        noise = ((None,) * 3 if rng else tuple(r.data_ptr() for r in rows)) + (key.data_ptr() if rng else None,)
        base = (0,)
    err = getattr(sf._library(), entry)(
        int(emit_final), int(rng), ctypes.byref(sf._params_struct(env)), st.data_ptr(), act.data_ptr(), *noise,
        *(t.data_ptr() for t in outs), *base, b, torch.cuda.current_stream().cuda_stream)
    assert err == 0, entry
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("batch", [8191, 16385])
@pytest.mark.parametrize("env_id", ["SSLStaticDefenders-v0", "SSLDribbling-v0"])
@pytest.mark.parametrize("rng_mode", ["input", "kernel"])
@pytest.mark.parametrize("emit_final", [False, True], ids=["obs", "final_obs"])
def test_ssl_one_thread_kernel_bit_equal_to_group_kernel(cuda, env_id, batch, rng_mode, emit_final):
    """SD's and DR's one-thread kernels give their group kernels' bits,
    through auto-resets that fall on a few envs of a warp at a time (the
    one-thread SD kernel spreads them over the warp), at batches that
    leave the last block part empty."""
    draw = SSL[env_id][2]
    entry = ENTRY[env_id]
    env = rsoccer_tpu_torch.make(env_id)
    env.max_episode_steps = 3
    key = make_key(6, device=cuda)
    st, _ = BatchedEnv(env, batch, device=cuda, fused=True).reset(key)
    st = stagger(st, env.n_robots)
    gen = torch.Generator(device=cuda).manual_seed(8)
    dones = 0
    for t in range(5):
        act = torch.rand((env.action_size, batch), generator=gen, device=cuda) * 2 - 1
        rows = draw(env, key.clone(), batch)
        k = key if rng_mode == "kernel" else None
        group = ssl_entry(entry, env, st, act, rows, k, emit_final)
        thread = ssl_entry(entry + "_one_thread", env, st, act, rows, k, emit_final)
        assert bit_equal(thread, group), f"step {t}"
        dones += int(group[2][1:3].sum())
        key[2:].add_(1)
        st = group[0]
    assert dones >= batch


@pytest.mark.parametrize("env_id", list(SSL))
def test_ssl_main_path_goes_through_the_kernel(cuda, env_id):
    """Its kernel launches once per step, through the C entry its route
    names, and no other kernel launches."""
    wrapper = SSL[env_id][0]
    env = rsoccer_tpu_torch.make(env_id)
    if env_id == "SSLDribbling-v0":
        env.max_episode_steps = 10  # its episodes rarely end in 20 random steps
    benv = BatchedEnv(env, B, device=cuda, fused=True, fused_rng="kernel")
    carry = R.init_carry(benv, seed=0)
    launches = launch_counts()
    before = tracing.snapshot()
    carry, ms = R.make_rollout_fn(benv, 20)(carry)
    assert launch_counts() == [n + 20 * (w is wrapper) for n, w in zip(launches, WRAPPERS)]
    assert tracing.entry_launches(wrapper, since=before) == {sf.routed_entry(ENTRY[env_id], B): 20}
    assert bool(torch.isfinite(carry.obs).all()) and bool(torch.isfinite(carry.state).all())
    assert bool((carry.obs.abs() <= torch.tensor(1.2)).all())
    assert int(ms.episodes) > 0


@pytest.mark.parametrize("env_id", list(SSL))
def test_ssl_bad_operands_raise(cuda, env_id):
    wrapper = SSL[env_id][0]
    env = rsoccer_tpu_torch.make(env_id)
    st = BatchedEnv(env, B, device=cuda, fused=True).reset(make_key(0, device=cuda))[0]
    key = make_key(0, device=cuda)
    a = env.action_size
    with pytest.raises(ValueError):
        wrapper(env, st, torch.zeros((a - 1, B), device=cuda), key=key)
    with pytest.raises(ValueError):
        wrapper(env, st[:, :-1], torch.zeros((a, B - 1), device=cuda), key=key)
    with pytest.raises(ValueError):
        wrapper(env, st, torch.zeros((a, B), device=cuda), key=key.cpu())
    env.physics_cfg = dataclasses.replace(env.physics_cfg, n_substeps=3)
    with pytest.raises(NotImplementedError):
        wrapper(env, st, torch.zeros((a, B), device=cuda), key=key)


def random_vss_arrays(gen, dev, n=6, batch=B):
    """Random VSS worlds as the physics kernel takes them: robots (6, n,
    batch) crowded enough to touch, half the balls airborne, wheel commands
    past the clamp."""
    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    rb = torch.stack([u((n, batch), -0.6, 0.6), u((n, batch), -0.5, 0.5), u((n, batch), -math.pi, math.pi),
                      u((n, batch), -0.5, 0.5), u((n, batch), -0.5, 0.5), u((n, batch), -5, 5)])
    air = u((batch,), 0, 1) < 0.5
    ball = torch.stack([u((batch,), -0.6, 0.6), u((batch,), -0.5, 0.5),
                        0.0215 + torch.where(air, u((batch,), 0, 0.3), 0.0),
                        u((batch,), -1, 1), u((batch,), -1, 1), torch.where(air, u((batch,), -1, 2), 0.0)])
    return rb.contiguous(), ball.contiguous(), u((2, n, batch), -40, 40)


def check_vss_physics(cuda, batch, trials=5, **env_kwargs):
    env = rsoccer_tpu_torch.make("VSS-v0", **env_kwargs)
    gen = torch.Generator(device=cuda).manual_seed(3)
    before = tracing.snapshot()
    for trial in range(trials):
        rb, ball, cmd = random_vss_arrays(gen, cuda, n=env.n_robots, batch=batch)
        k_rb, k_ball = vp.vss_physics(env, rb, ball, cmd)
        p_rb, p_ball = vp.vss_physics_plain(env, rb, ball, cmd)
        d_th = (torch.remainder(k_rb[2] - p_rb[2] + math.pi, 2 * math.pi) - math.pi).abs()
        assert float(d_th.max()) <= ATOL, trial
        assert float((k_rb[[0, 1, 3, 4, 5]] - p_rb[[0, 1, 3, 4, 5]]).abs().max()) <= ATOL, trial
        assert float((k_ball - p_ball).abs().max()) <= ATOL, trial
    assert tracing.launches(vp.vss_physics, since=before) == trials


def test_vss_physics_kernel_matches_plain(cuda):
    check_vss_physics(cuda, B)


@pytest.mark.parametrize("config", ["3v3", "5v5"])
def test_vss_physics_kernel_matches_native_oracle(cuda, config):
    """K2 against the C++ oracle (``ops/native.batched_vss_oracle``) on
    each of 5 steps from the same state: 2e-4 on ball and robots, 5e-3 on
    wheel speeds (tests/test_native_oracle.py's protocol)."""
    from rsoccer_tpu_torch.core.state import VSSCommands
    from rsoccer_tpu_torch.ops import native

    env = rsoccer_tpu_torch.make("VSS-v0", **VSS_CONFIGS.get(config, {}))
    gen = torch.Generator(device=cuda).manual_seed(8)
    rb, ball, _ = random_vss_arrays(gen, cuda, n=env.n_robots)
    world = vp._world(rb, ball, env.field.rbt_wheel_radius)
    before = tracing.snapshot()
    for t in range(5):
        cmd = VSSCommands(*(torch.rand((2, env.n_robots, B), generator=gen, device=cuda) * 100 - 50))
        got = vp.world_step(env, world, cmd)
        want = native.batched_vss_oracle(world, cmd, env.field, env.physics_cfg, env.time_step)
        native.check_oracle(native.world_errors(got, want), f"{config} step {t}")
        world = got
    assert tracing.launches(vp.vss_physics, since=before) == 5


@pytest.mark.parametrize("batch", RAGGED)
def test_vss_physics_kernel_matches_plain_ragged(cuda, batch):
    check_vss_physics(cuda, batch)


@pytest.mark.parametrize("batch", [B, 8191])
@pytest.mark.parametrize("config", ["5v5", "1v0"])
def test_vss_physics_kernel_matches_plain_configs(cuda, config, batch):
    """The one-thread physics kernel at N = 10 and N = 1."""
    check_vss_physics(cuda, batch, **VSS_CONFIGS[config])


@pytest.mark.parametrize("n", [6, 10])
def test_vss_physics_one_thread_kernel_bit_equal_to_group_kernel(cuda, n):
    """N = 6 on 8 lanes and N = 10 on 16: the one-thread kernel's bits."""
    env = rsoccer_tpu_torch.make("VSS-v0", **(VSS_CONFIGS["5v5"] if n == 10 else {}))
    gen = torch.Generator(device=cuda).manual_seed(4)
    lib = vp._library()
    for trial in range(5):
        rb, ball, cmd = random_vss_arrays(gen, cuda, n=n)
        outs = {}
        for entry in ("vss_physics_step", "vss_physics_step_one_thread"):
            outs[entry] = (torch.full_like(rb, float("nan")), torch.full_like(ball, float("nan")))
            assert getattr(lib, entry)(
                ctypes.byref(vp._params_struct(env)), rb.data_ptr(), ball.data_ptr(), cmd.data_ptr(),
                *(t.data_ptr() for t in outs[entry]), env.n_robots, B,
                torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        assert bit_equal(*outs.values()), trial


@pytest.mark.parametrize("physics", [False, True], ids=["fused", "fused_physics"])
def test_5v5_main_path_goes_through_the_kernel(cuda, physics):
    """make_vec's 5v5 path: its kernel launches once per step, no other
    kernel launches, and the outputs stay finite and inside the obs bounds."""
    wrapper = vp.vss_physics if physics else vf.vss_full_step
    benv = rsoccer_tpu_torch.make_vec("VSS-v0", B, device=cuda, fused=not physics, fused_rng="kernel",
                                      fused_physics=physics, **VSS_CONFIGS["5v5"])
    benv.env.max_episode_steps = 8
    launches = launch_counts()
    carry, ms = R.make_rollout_fn(benv, 20)(R.init_carry(benv, seed=0))
    assert launch_counts() == [n + 20 * (w is wrapper) for n, w in zip(launches, WRAPPERS)]
    assert tuple(carry.obs.shape) == (64, B) and bool(torch.isfinite(carry.obs).all())
    assert bool((carry.obs.abs() <= torch.tensor(1.2)).all())
    assert int(ms.episodes) > 0


def test_fused_physics_main_path_goes_through_the_kernel(cuda):
    """The physics kernel launches once per step, no other kernel launches,
    and the rollout matches the unfused one."""
    env = rsoccer_tpu_torch.make("VSS-v0")
    env.max_episode_steps = 8
    benv = BatchedEnv(env, B, device=cuda, fused_physics=True)
    twin = BatchedEnv(env, B, device=cuda)
    launches = launch_counts()
    carry, ms = R.make_rollout_fn(benv, 20)(R.init_carry(benv, seed=0))
    assert launch_counts() == [n + 20 * (w is vp.vss_physics) for n, w in zip(launches, WRAPPERS)]
    c_t, m_t = R.make_rollout_fn(twin, 20)(R.init_carry(twin, seed=0))
    assert int(ms.episodes) == int(m_t.episodes) > 0
    assert float((carry.obs - c_t.obs).abs().max()) <= 1e-3
    assert bool(torch.isfinite(carry.obs).all())


@pytest.mark.parametrize("batch", [B, 8191])
@pytest.mark.parametrize("env_id", ["VSSMultiAgent-v0", "VSSSelfPlay-v0"])
def test_vss_physics_under_multiagent_actions(cuda, env_id, batch):
    """The physics kernel on a ``fused_physics`` rollout of the multi-agent
    and self-play envs, every robot's wheels from a policy-like map of the
    obs, through auto-resets: at each step the kernel against its plain
    version on that step's arrays, and the whole step against the unfused
    one fed the same noise."""
    env = rsoccer_tpu_torch.make(env_id)
    env.max_episode_steps = 3
    fused = BatchedEnv(env, batch, device=cuda, fused_physics=True)
    twin = BatchedEnv(env, batch, device=cuda)
    key = make_key(11, device=cuda)
    st, obs = fused.reset(key)
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn((env.action_size, env.obs_size), generator=gen, device=cuda)
    before, dones = tracing.snapshot(), 0
    act_shape = (env.action_size, batch)
    for _ in range(6):
        act = torch.clamp(torch.tanh(1.5 * w @ obs) + 0.3 * torch.randn(act_shape, generator=gen,
                                                                          device=cuda), -1.0, 1.0)
        t_noise, r_noise = fused._draw(key)
        cmd, _ = env.pre_physics(st, act, t_noise)
        rb, ball = vp._stack(st.world)
        cmd = torch.stack([cmd.v_wheel0, cmd.v_wheel1])
        k_rb, k_ball = vp.vss_physics(env, rb, ball, cmd)
        p_rb, p_ball = vp.vss_physics_plain(env, rb, ball, cmd)
        d_th = (torch.remainder(k_rb[2] - p_rb[2] + math.pi, 2 * math.pi) - math.pi).abs()
        assert float(d_th.max()) <= ATOL
        assert float((k_rb[[0, 1, 3, 4, 5]] - p_rb[[0, 1, 3, 4, 5]]).abs().max()) <= ATOL
        assert float((k_ball - p_ball).abs().max()) <= ATOL
        got = fused.step_with_noise(st, act, t_noise, r_noise)
        want = twin.step_with_noise(st, act, t_noise, r_noise)
        assert float((got[1] - want[1]).abs().max()) <= ATOL
        assert float((got[2] - want[2]).abs().max()) <= ATOL
        assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
        dones += int((got[3] | got[4]).sum())
        st, obs = got[0], got[1]
    assert tracing.launches(vp.vss_physics, since=before) == 12 and dones > 0


def test_vss_physics_bad_operands_raise(cuda):
    env = rsoccer_tpu_torch.make("VSS-v0")
    rb, ball, cmd = random_vss_arrays(torch.Generator(device=cuda).manual_seed(0), cuda)
    with pytest.raises(ValueError):
        vp.vss_physics(env, rb, ball[:5], cmd)
    with pytest.raises(ValueError):
        vp.vss_physics(env, rb, ball, cmd.cpu())
    with pytest.raises(ValueError):
        vp.vss_physics(env, rb.transpose(1, 2).contiguous().transpose(1, 2), ball, cmd)  # strided
    with pytest.raises(ValueError):  # the arrays' robots are not the env's
        vp.vss_physics(rsoccer_tpu_torch.make("VSS-v0", **VSS_CONFIGS["5v5"]), rb, ball, cmd)
    odd = rsoccer_tpu_torch.make("VSS-v0", n_robots_blue=6, n_robots_yellow=6)  # past 10 robots
    rb12, ball12, cmd12 = random_vss_arrays(torch.Generator(device=cuda).manual_seed(0), cuda, n=12)
    with pytest.raises(NotImplementedError):
        vp.vss_physics(odd, rb12, ball12, cmd12)


def test_ppo_rollout_on_the_card_matches_the_cpu(cuda):
    """PPOTrainer._rollout through K1's emit_final variant against the same
    rollout on the CPU (the plain version), fed the same draws: an f32 net,
    max steps 4 so lanes truncate inside the rollout."""
    from rsoccer_tpu_torch.models.networks import ActorCritic
    from rsoccer_tpu_torch.models.ppo import ObsNorm, PPOConfig, PPOTrainer

    n_t, b = 8, 256
    env = rsoccer_tpu_torch.make("VSS-v0")
    env.max_episode_steps = 4
    cpu_benv = BatchedEnv(env, b, device="cpu", fused=True)
    state, obs = cpu_benv.reset(make_key(7, device="cpu"))
    key = make_key(8, device="cpu")
    env_noise = [cpu_benv._draw(key) for _ in range(n_t)]
    action_noise = torch.randn((n_t, b, env.action_size), generator=torch.Generator().manual_seed(9))
    out = {}
    for dev in ("cpu", "cuda"):
        trainer = PPOTrainer(BatchedEnv(env, b, device=dev, fused=True), PPOConfig(rollout_steps=n_t))
        net = ActorCritic(env.obs_size, env.action_size, (64, 64), compute_dtype=torch.float32,
                          device=dev, seed=3)
        draws = (action_noise.to(dev),
                 [tuple({k: v.to(dev) for k, v in d.items()} for d in nz) for nz in env_noise])
        before = tracing.snapshot()
        *_, out[dev] = trainer._rollout(net, state.to(dev), obs.to(dev), None,
                                        ObsNorm.init(env.obs_size, dev), None, draws)
    assert tracing.launches(vf.vss_full_step, final=True, since=before) == n_t  # the card's rollout
    assert float(out["cpu"].trunc.sum()) >= b
    for name in ("obs", "action", "logp", "value", "reward", "boot_value"):
        got, want = getattr(out["cuda"], name).cpu(), getattr(out["cpu"], name)
        assert float((got - want).abs().max()) <= 2e-4, name
    assert torch.equal(out["cuda"].term.cpu(), out["cpu"].term)
    assert torch.equal(out["cuda"].trunc.cpu(), out["cpu"].trunc)


def test_ppo_train_step_on_the_card(cuda):
    """A PPO update on the card: K1's emit_final variant once per step,
    finite metrics, every parameter moved."""
    from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer

    benv = rsoccer_tpu_torch.make_vec("VSS-v0", B, fused=True, fused_rng="kernel")
    trainer = PPOTrainer(benv, PPOConfig(rollout_steps=16, hidden=(64, 64), num_epochs=2, num_minibatches=4))
    state = trainer.init(0)
    p0 = [p.detach().clone() for p in state.net.parameters()]
    before = tracing.snapshot()
    state, metrics = trainer.train_step(state)
    assert tracing.launches(vf.vss_full_step, final=True, since=before) == 16
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(p0, state.net.parameters()))


def test_sac_train_step_on_the_card(cuda):
    """One SAC iteration on the fused path: K4's emit_final variant once,
    through the group kernel's C entry, no other launch; finite metrics,
    the actor and critics moved."""
    from rsoccer_tpu_torch.models.sac import SACConfig, SACTrainer, iteration_generator

    benv = rsoccer_tpu_torch.make_vec("SSLStaticDefenders-v0", B, fused=True, fused_rng="kernel")
    trainer = SACTrainer(benv, SACConfig(buffer_size=4 * B, batch_size=64, warmup_steps=0, hidden=(64, 64)))
    state = trainer.init(0)
    p0 = [p.detach().clone() for p in (*state.actor.parameters(), *state.qs.parameters())]
    wrappers = (sf.sd_full_step, sf.cp_full_step, sf.dr_full_step, sf.pe_full_step, vf.vss_full_step)
    before = tracing.snapshot()
    state, metrics = trainer.train_step(state, iteration_generator(0, 0))
    assert [tracing.launches(w, since=before) for w in wrappers] == [1, 0, 0, 0, 0]
    assert tracing.launches(sf.sd_full_step, final=True, since=before) == 1
    assert tracing.entry_launches(sf.sd_full_step, since=before) == {"ssl_sd_full_step": 1}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(p0, (*state.actor.parameters(), *state.qs.parameters())))


def test_expert_step_on_the_fused_path(cuda):
    """One scripted-expert step on the fused path (unpack_state -> the PE
    expert -> the step) is one launch of K7 through ssl_pe_full_step and
    no other kernel; the actions are finite (3, B)."""
    from rsoccer_tpu_torch.experts import EXPERTS

    benv = rsoccer_tpu_torch.make_vec("SSLPassEndurance-v0", B, fused=True, fused_rng="kernel")
    expert = EXPERTS["SSLPassEndurance-v0"](benv.env)
    key = make_key(0)
    state, _ = benv.reset(key)
    wrappers = (sf.sd_full_step, sf.cp_full_step, sf.dr_full_step, sf.pe_full_step, vf.vss_full_step)
    before = tracing.snapshot()
    act = expert(benv.unpack_state(state))
    state, obs, *_ = benv.step(state, act, key)
    assert [tracing.launches(w, since=before) for w in wrappers] == [0, 0, 0, 1, 0]
    assert tracing.launches(sf.pe_full_step, final=True, since=before) == 0
    assert tracing.entry_launches(sf.pe_full_step, since=before) == {"ssl_pe_full_step": 1}
    assert act.shape == (3, B) and bool(torch.isfinite(act).all()) and bool(torch.isfinite(obs).all())


@pytest.mark.parametrize("env_id", ["VSS-v0", *SSL])
def test_host_vector_env_fused_matches_plain(cuda, env_id):
    """HostVectorEnv (the gymnasium vector wrapper's numpy core) through
    the fused kernel's emit_final variant with kernel RNG, held to the
    unfused path on the card from the same seed (one Philox stream) over
    6 steps with a step limit of 3: obs, reward, info and final_obs within
    ATOL, the flags and the SAME_STEP masks exactly, every env through a
    reset; one launch per step, all emit_final."""
    import numpy as np

    from rsoccer_tpu_torch.batch.host import HostVectorEnv

    fused = HostVectorEnv(env_id, B, fused=True, fused_rng="kernel")
    plain = HostVectorEnv(env_id, B, fused=False)
    fused.env.max_episode_steps = plain.env.max_episode_steps = 3
    wrapper = vf.vss_full_step if env_id == "VSS-v0" else SSL[env_id][0]
    before = tracing.snapshot()
    got, want = fused.reset(seed=6)[0], plain.reset(seed=6)[0]
    assert float(np.abs(got - want).max()) <= ATOL
    rng = np.random.default_rng(7)
    seen = np.zeros(B, bool)
    for t in range(6):
        act = rng.uniform(-1, 1, (B, fused.env.action_size)).astype(np.float32)
        got, want = fused.step(act), plain.step(act)
        for a, b in ((got[0], want[0]), (got[1], want[1])):
            assert float(np.abs(a - b).max()) <= ATOL, t
        assert np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3]), t
        assert sorted(got[4]) == sorted(want[4]), t
        for k, v in want[4].items():
            if k in ("final_obs", "final_info"):
                continue
            if k.startswith("_final"):
                assert np.array_equal(got[4][k], v), (t, k)
            else:
                assert float(np.abs(got[4][k] - v).max()) <= ATOL, (t, k)
        if "_final_obs" in want[4]:
            for i in np.nonzero(want[4]["_final_obs"])[0]:
                assert float(np.abs(got[4]["final_obs"][i] - want[4]["final_obs"][i]).max()) <= ATOL, (t, i)
            seen |= want[4]["_final_obs"]
    assert seen.all()
    assert tracing.launches(wrapper, since=before) == 6
    assert tracing.launches(wrapper, final=True, since=before) == 6


EPILOGUE_STEPS = 12


def plain_rollout(benv, carry, n_steps):
    """The plain torch bookkeeping on the card, with the policy's former
    draw (``rand * 2 - 1``), and per step the reward and done flags on the
    host for a float64 recount."""
    def old_policy(gen, obs):
        return torch.rand((benv.action_size, obs.shape[-1]), generator=gen, device=obs.device) * 2.0 - 1.0

    seen = []

    def metrics(reward, done, ep_ret, ep_len, info):
        seen.append((reward.cpu().double(), done.cpu()))
        return R.rollout_metrics(reward, done, ep_ret, ep_len, info)

    one_step = R.make_step_fn(benv, old_policy, metrics)
    carry, total = one_step(carry)
    for _ in range(n_steps - 1):
        carry, m = one_step(carry)
        total = tree_map(torch.add, total, m)
    return carry, total, seen


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def as_f32(x: float) -> float:
    """``x`` rounded once to float32, the metrics' dtype."""
    return float(torch.tensor(x, dtype=torch.float64).float())


# 65536 + 37 ends in a tail that is no multiple of the block; at 1048576
# each thread of the epilogue's capped grid makes one pass, at 2097152 two
@pytest.mark.parametrize("batch", [65536, 65536 + 37, 1048576, 2097152])
@pytest.mark.parametrize("env_id", ["VSS-v0", "SSLStaticDefenders-v0"])
def test_rollout_epilogue_against_the_plain_bookkeeping(cuda, env_id, batch):
    """The rollout on the card (one epilogue kernel a step, one finish a
    call) against the plain torch bookkeeping on the card: the carries bit
    for bit, the episode count and length sum exactly as a float64 recount
    on the host (the length sum rounded once to its float32), the reward
    sums within rel 1e-6 of it; two runs give the same metrics; the counter
    reads a launch a step and a finish."""
    from rsoccer_tpu_torch.ops import rollout_epilogue

    env = rsoccer_tpu_torch.make(env_id)
    env.max_episode_steps = 5  # episodes end inside the window
    benv = BatchedEnv(env, batch, device=cuda, fused=True, fused_rng="kernel")
    before = tracing.snapshot()
    roll = R.make_rollout_fn(benv, EPILOGUE_STEPS)
    c_e, m_e = roll(R.init_carry(benv, seed=2**31 + 11))
    assert tracing.entry_launches(rollout_epilogue.WRAPPER, since=before) == {
        "rollout_epilogue": EPILOGUE_STEPS, "rollout_epilogue_finish": 1}
    c_p, m_p, seen = plain_rollout(benv, R.init_carry(benv, seed=2**31 + 11), EPILOGUE_STEPS)
    for a, b in zip((c_e.state, c_e.obs, c_e.key, c_e.ep_return, c_e.ep_length),
                    (c_p.state, c_p.obs, c_p.key, c_p.ep_return, c_p.ep_length)):
        assert torch.equal(bits(a), bits(b))

    ret, length = torch.zeros(batch, dtype=torch.float64), torch.zeros(batch, dtype=torch.float64)
    tot_r = eps = ret_sum = len_sum = 0.0
    for r, done in seen:
        ret, length = ret + r, length + 1
        tot_r += float(r.sum())
        eps += int(done.sum())
        ret_sum += float(ret[done].sum())
        len_sum += float(length[done].sum())
        ret[done], length[done] = 0.0, 0.0
    assert eps > 0 and int(m_e.episodes) == eps and m_e.episodes.dtype == torch.int64
    assert float(m_e.episode_length_sum) == as_f32(len_sum)
    assert float(m_e.total_reward) == pytest.approx(tot_r, rel=1e-6)
    assert float(m_e.episode_return_sum) == pytest.approx(ret_sum, rel=1e-6)
    assert [m.dtype for m in m_e] == [m.dtype for m in m_p]
    _, m_again = roll(R.init_carry(benv, seed=2**31 + 11))
    for a, b in zip(m_e, m_again):
        assert torch.equal(a, b)


def misaligned(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``t`` that starts ``offset`` elements into a fresh buffer."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:]
    out.copy_(t)
    return out


# 4099: one block's grid and a scalar tail; 2097152 + 37: the capped grid,
# two passes of each thread and a tail.  Offset 1 leaves every operand off
# its 16-byte (floats) and 4-byte (flags) alignment: the all-scalar variant
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("batch", [4099, 2097152 + 37])
def test_rollout_epilogue_kernel_against_plain_ops(cuda, batch, offset):
    """Three epilogue steps on drawn operands against the plain loop's
    torch ops: each step's accumulators bit for bit, and the finished sums
    against a float64 recount: the episode count and length sum exactly
    (the length sum rounded once to float32), the reward sums within rel
    1e-6."""
    from rsoccer_tpu_torch.ops import rollout_epilogue

    g = torch.Generator(device=cuda).manual_seed(2**31 + 21)
    ep_ret = torch.randn(batch, generator=g, device=cuda) * 10.0
    ep_len = torch.randint(0, 300, (batch,), generator=g, device=cuda).float()
    acc = rollout_epilogue.scratch(cuda)
    tot_r = eps = ret_sum = len_sum = 0.0
    for step in range(3):
        reward = torch.randn(batch, generator=g, device=cuda)
        term = torch.rand(batch, generator=g, device=cuda) < 0.05
        trunc = torch.rand(batch, generator=g, device=cuda) < 0.02
        ins = [misaligned(t, offset) for t in (reward, term, trunc, ep_ret, ep_len)]
        off = [t.data_ptr() % (16 if t.is_floating_point() else 4) != 0 for t in ins]
        assert off == [offset == 1] * len(ins)
        got_ret, got_len = rollout_epilogue.epilogue(*ins, acc, first=step == 0)
        done = term | trunc
        er, el = ep_ret + reward, ep_len + 1.0
        ep_ret, ep_len = torch.where(done, 0.0, er), torch.where(done, 0.0, el)
        assert torch.equal(got_ret.view(torch.int32), ep_ret.view(torch.int32))
        assert torch.equal(got_len.view(torch.int32), ep_len.view(torch.int32))
        tot_r += float(reward.double().sum())
        eps += int(done.sum())
        ret_sum += float(er.double()[done].sum())
        len_sum += float(el.double()[done].sum())
    total, episodes, ret_got, len_got = rollout_epilogue.finish(acc, batch)
    assert episodes.dtype == torch.int64 and int(episodes) == eps > 0
    assert float(len_got) == as_f32(len_sum)
    assert float(total) == pytest.approx(tot_r, rel=1e-6)
    assert float(ret_got) == pytest.approx(ret_sum, rel=1e-6)


@pytest.mark.parametrize("shape", [(2, 1048576), (5, 2097152), (5, 65536 + 37)])
def test_uniform_policy_draw_on_the_card(cuda, shape):
    """The policy's one ``uniform_`` draw is the bits of ``rand * 2 - 1`` on
    the card and advances the generator alike."""
    g_new, g_old = (torch.Generator(device=cuda).manual_seed(2**31 + 3) for _ in range(2))
    for _ in range(2):
        got = R.uniform_policy(shape[0])(g_new, torch.zeros((1, shape[1]), device=cuda))
        want = torch.rand(shape, generator=g_old, device=cuda) * 2.0 - 1.0
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(g_new.get_state(), g_old.get_state())
