"""The fused VSS step's plain version vs the JAX package's Pallas kernel
(interpret mode) at 3v3, 5v5, 1v0 and beyond the Taylor bound, the
wrappers' kernel routes, and the port's Philox stream: known answers, slot
layout, moments, and its kernel-RNG mode held against the JAX kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu.ops.pallas_vss_full import make_pallas_vss_full_step
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.envs.base import draw_noise, step_noise_spec
from rsoccer_tpu_torch.ops import philox
from rsoccer_tpu_torch.ops import vss_full as vf
from rsoccer_tpu_torch.utils import tracing

torch.set_num_threads(1)

B = 16
ATOL = 5e-5
# team sizes and time steps the kernels run: 3v3, VSS's 5v5 division on its
# own field, 1v0 (no robot pairs), 3v3 beyond the Taylor bound (exact trig)
CONFIGS = {
    "3v3": {},
    "5v5": dict(field_type=1, n_robots_blue=5, n_robots_yellow=5),
    "1v0": dict(n_robots_blue=1, n_robots_yellow=0),
    "3v3_dt0.1": dict(time_step=0.1),
}


def pair(max_steps=None, **kwargs):
    jenv, tenv = rsoccer_tpu.make("VSS-v0", **kwargs), rsoccer_tpu_torch.make("VSS-v0", **kwargs)
    if max_steps is not None:
        jenv.max_episode_steps = tenv.max_episode_steps = max_steps
    return jenv, tenv


def reset_packed(tenv, seed):
    return BatchedEnv(tenv, B, device="cpu", fused=True).reset(philox.make_key(seed, device="cpu"))[0]


def assert_step_close(got, want, tag, n=6):
    """(state, obs, aux) of the port vs the JAX kernel's, as numpy, for n
    robots."""
    st, obs, aux = (np.asarray(a) for a in got)
    w_st, w_obs, w_aux = (np.asarray(a) for a in want)
    steps_row, theta = 6 + 6 * n, slice(6 + 2 * n, 6 + 3 * n)
    d_th = np.remainder(st[theta] - w_st[theta] + np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(d_th, 0.0, atol=ATOL, err_msg=f"{tag} theta")
    rows = [r for r in range(st.shape[0]) if r != steps_row and not 6 + 2 * n <= r < 6 + 3 * n]
    np.testing.assert_allclose(st[rows], w_st[rows], atol=ATOL, err_msg=f"{tag} state")
    np.testing.assert_array_equal(st[steps_row], w_st[steps_row], err_msg=f"{tag} steps")
    np.testing.assert_allclose(obs, w_obs, atol=ATOL, err_msg=f"{tag} obs")
    np.testing.assert_allclose(aux[0], w_aux[0], atol=ATOL, err_msg=f"{tag} reward")
    np.testing.assert_array_equal(aux[1:3], w_aux[1:3], err_msg=f"{tag} term/trunc")
    np.testing.assert_allclose(aux[3:], w_aux[3:], atol=ATOL, err_msg=f"{tag} shaping")


@pytest.mark.parametrize("emit_final", [False, True], ids=["obs", "final_obs"])
@pytest.mark.parametrize("max_steps", [None, 3], ids=["limit1200", "limit3"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_plain_matches_jax_kernel(config, emit_final, max_steps):
    jenv, tenv = pair(max_steps, **CONFIGS[config])
    n = tenv.n_robots
    jstep = make_pallas_vss_full_step(jenv, B, tile=B, interpret=True, emit_final_obs=emit_final)
    rng = np.random.default_rng(21 + (max_steps or 0))
    st_t = reset_packed(tenv, seed=4)
    st_j = jnp.asarray(st_t.numpy())
    n_sp = (1 + n) * 2 * 8
    dones = 0
    for t in range(6):
        act = rng.uniform(-1, 1, (2, B)).astype(np.float32)
        ou = rng.normal(size=(2 * n, B)).astype(np.float32)
        sp = rng.uniform(size=(n_sp, B)).astype(np.float32)
        th = rng.uniform(size=(n, B)).astype(np.float32)
        want = jstep(st_j, *(jnp.asarray(a) for a in (act, ou, sp, th)))
        got = vf.vss_full_step_plain(
            tenv, st_t, *(torch.from_numpy(a) for a in (act, ou, sp, th)), emit_final
        )
        assert got[1].shape == (tenv.obs_size * (2 if emit_final else 1), B)
        assert_step_close(got, want, f"step {t}", n)
        dones += int(got[2][1:3].sum())
        st_t, st_j = got[0], want[0]
    if max_steps is not None:
        assert dones > 0


@pytest.mark.parametrize("config", list(CONFIGS))
def test_kernel_rng_mode_matches_jax_kernel(config):
    """The port's in-kernel-RNG stream, repacked as the JAX kernel's input
    rows, gives the JAX kernel's outputs: the kernel-RNG mode held to the
    reference (which the TPU's hardware PRNG never allowed)."""
    jenv, tenv = pair(max_steps=4, **CONFIGS[config])
    jstep = make_pallas_vss_full_step(jenv, B, tile=B, interpret=True)
    key = philox.make_key(77, device="cpu")
    st_t = reset_packed(tenv, seed=5)
    st_j = jnp.asarray(st_t.numpy())
    rng = np.random.default_rng(3)
    for t in range(6):
        act = torch.from_numpy(rng.uniform(-1, 1, (2, B)).astype(np.float32))
        rows = vf.draw_step_rows(tenv, key.clone(), B)  # what the kernel draws
        want = jstep(st_j, jnp.asarray(act.numpy()), *(jnp.asarray(r.numpy()) for r in rows))
        step_before = int(key[2])
        got = vf.vss_full_step(tenv, st_t, act, key=key)
        assert int(key[2]) == step_before + 1
        assert_step_close(got, want, f"step {t}", tenv.n_robots)
        st_t, st_j = got[0], want[0]


@pytest.mark.parametrize(
    "ctr, key, want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(ctr, key, want):
    """Random123's published Philox4x32-10 known-answer vectors."""
    t = [torch.tensor(v, dtype=torch.int64) for v in ctr + key]
    got = tuple(int(w) for w in philox.philox4x32(*t))
    assert got == want


def test_draw_noise_slot_layout():
    """Spawn, theta, then the OU normals' u1 and u2 blocks: the slots the
    kernel reads (csrc/vss_full.cu), word = slot % 4 of block slot // 4."""
    tenv = rsoccer_tpu_torch.make("VSS-v0")
    assert list(step_noise_spec(tenv)) == ["spawn", "theta", "ou"]
    n_slots = 112 + 6 + 2 * 12  # spawn, theta, two uniforms per OU normal
    key = philox.make_key(9, device="cpu")
    key[2] = (1 << 32) + 5  # both counter words in play
    words = philox.philox_words(key, n_slots, B)
    u = philox.uniforms_from_words(words)
    ou, sp, th = vf.draw_step_rows(tenv, key, B)
    assert int(key[2]) == (1 << 32) + 6
    torch.testing.assert_close(sp, u[:112], rtol=0, atol=0)
    torch.testing.assert_close(th, u[112:118], rtol=0, atol=0)
    normals = philox.box_muller(u[118:130], u[130:142])  # (robot, wheel) flat
    want_ou = torch.cat([normals[0::2], normals[1::2]])  # wheel-major rows
    torch.testing.assert_close(ou, want_ou, rtol=0, atol=0)
    # the block/word mapping itself, for one env and slot
    b, slot = 3, 117
    w = philox.philox4x32(
        torch.tensor(b), torch.tensor(slot // 4), torch.tensor(5), torch.tensor(1),
        key[0], key[1],
    )
    assert int(w[slot % 4]) == int(words[slot, b])


def test_philox_moments():
    """64 envs x 142 slots: uniform and normal moments within 4 sigma,
    and distinct streams for distinct steps, envs and keys."""
    spec = {"u": ((142,), "uniform"), "n": ((71,), "normal")}
    key = philox.make_key(2024, device="cpu")
    noise = draw_noise(key, spec, 64)
    u = noise["u"].double().flatten()
    n = noise["n"].double().flatten()
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    k = u.numel()
    assert abs(float(u.mean()) - 0.5) < 4 * (1 / 12 / k) ** 0.5
    assert abs(float(u.var()) - 1 / 12) < 4 * (1 / 180 / k) ** 0.5
    k = n.numel()
    assert abs(float(n.mean())) < 4 * (1 / k) ** 0.5
    assert abs(float(n.var()) - 1.0) < 4 * (2 / k) ** 0.5
    again = draw_noise(key, spec, 64)["u"]
    assert not torch.equal(again, noise["u"])  # next step, new words
    assert not torch.equal(noise["u"][:, 0], noise["u"][:, 1])  # envs differ
    other = draw_noise(philox.make_key(2024, stream=1, device="cpu"), spec, 64)["u"]
    assert not torch.equal(other, noise["u"])


def test_wrapper_dispatch_on_cpu():
    """On CPU the wrapper runs the plain version (never the kernel), with
    the Philox rows when given a key; it refuses ambiguous noise."""
    tenv = rsoccer_tpu_torch.make("VSS-v0")
    st = reset_packed(tenv, seed=1)
    act = torch.zeros((2, B))
    key = philox.make_key(5, device="cpu")
    before = tracing.snapshot()
    got = vf.vss_full_step(tenv, st, act, key=key.clone())
    want = vf.vss_full_step_plain(tenv, st, act, *vf.draw_step_rows(tenv, key.clone(), B))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tracing.launches(vf.vss_full_step, since=before) == 0
    rows = vf.draw_step_rows(tenv, key.clone(), B)
    with pytest.raises(ValueError):
        vf.vss_full_step(tenv, st, act, *rows, key=key)
    with pytest.raises(ValueError):
        vf.vss_full_step(tenv, st, act)
    with pytest.raises(NotImplementedError):
        vf.vss_full_step(tenv, st.to("meta"), act.to("meta"), key=key)


@pytest.mark.parametrize(
    "kwargs, route",
    [
        ({}, "group"),
        (CONFIGS["3v3_dt0.1"], "group"),  # the group kernel's exact-trig policy
        (CONFIGS["5v5"], "group"),  # the 16-lane group kernel
        (CONFIGS["1v0"], "thread"),
        (dict(n_robots_blue=5, n_robots_yellow=0), "thread"),
        (dict(n_robots_blue=2, n_robots_yellow=4), "thread"),  # 6 robots, not 3v3
    ],
    ids=["3v3", "3v3_dt0.1", "5v5", "1v0", "5v0", "2v4"],
)
def test_route_by_team_size(kwargs, route):
    """3v3 runs on the 8-lane group kernel and 5v5 on the 16-lane one, each
    up to its crossover (GROUP_MAX_ENVS); every other team size on the
    one-thread kernel, at any batch."""
    env = rsoccer_tpu_torch.make("VSS-v0", **kwargs)
    assert vf.route(env, B) == route
    assert vf.route(env, 8192) == route  # the main path's batch
    assert vf.route(env, vf.GROUP_MAX_ENVS.get((env.n_blue, env.n_yellow), 0) + 1) == "thread"


@pytest.mark.parametrize("delta", [-1, 0, 1, 4096])
def test_route_at_the_crossover(delta):
    env = rsoccer_tpu_torch.make("VSS-v0")
    want = "group" if delta <= 0 else "thread"
    assert vf.route(env, vf.VSS_GROUP_MAX_ENVS + delta) == want


@pytest.mark.parametrize("delta", [-1, 0, 1, 4096])
def test_route_at_the_5v5_crossover(delta):
    env = rsoccer_tpu_torch.make("VSS-v0", **CONFIGS["5v5"])
    want = "group" if delta <= 0 else "thread"
    assert vf.route(env, vf.VSS_5V5_GROUP_MAX_ENVS + delta) == want
    assert vf.routed_entry(env, vf.VSS_5V5_GROUP_MAX_ENVS + delta) == (
        "vss_full_step" if want == "group" else "vss_full_step_one_thread")


@pytest.mark.parametrize(
    "kwargs",
    [dict(n_robots_blue=6, n_robots_yellow=6), dict(n_robots_blue=5, n_robots_yellow=6),
     dict(n_robots_blue=0, n_robots_yellow=3)],
    ids=["6v6", "5v6", "0v3"],
)
def test_route_refuses_outside_the_range(kwargs):
    """Outside 1-5 blue and 0-5 yellow robots there is no kernel: the
    wrapper refuses, naming the range, and never falls back."""
    env = rsoccer_tpu_torch.make("VSS-v0", **kwargs)
    with pytest.raises(NotImplementedError, match="1-5 blue and 0-5 yellow"):
        vf.route(env, B)


def test_trig_policy_follows_the_taylor_bound():
    """The kernels keep the Taylor rotation up to a 0.35 rad turn per
    substep (time_step 0.0584 s on the VSS fields) and take exact trig
    beyond it; every config of the tests is on the side it names."""
    assert vf.taylor_rotation_holds(rsoccer_tpu_torch.make("VSS-v0", time_step=0.0584))
    assert not vf.taylor_rotation_holds(rsoccer_tpu_torch.make("VSS-v0", time_step=0.0585))
    for name, kwargs in CONFIGS.items():
        assert vf.taylor_rotation_holds(rsoccer_tpu_torch.make("VSS-v0", **kwargs)) == ("dt" not in name)
