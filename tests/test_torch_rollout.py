"""The port's BatchedEnv and rollout loop: the fused path (its plain
version on the CPU) and the twin path agree with each other and with the
JAX package's fused kernel (interpret mode) under injected noise; the
rollout is deterministic and its metrics are the per-step sums."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu.batch.vecenv import BatchedEnv as JaxBatchedEnv
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.batch import rollout as R
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.core.state import tree_map
from rsoccer_tpu_torch.ops import rollout_epilogue
from rsoccer_tpu_torch.ops.vss_full import pack_vss_state
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.utils import tracing

torch.set_num_threads(1)

B = 16
ATOL = 5e-5


@pytest.fixture()
def interp_full(monkeypatch):
    """Interpret mode for the JAX fused VSS kernel on CPU."""
    import rsoccer_tpu.ops.pallas_vss_full as pvf

    monkeypatch.setattr(
        pvf, "make_pallas_vss_full_step",
        functools.partial(pvf.make_pallas_vss_full_step, interpret=True),
    )


def np_noise(rng, spec, b):
    return {
        name: (rng.uniform(size=shape + (b,)) if kind == "uniform" else rng.normal(size=shape + (b,))).astype(np.float32)
        for name, (shape, kind) in spec.items()
    }


@pytest.mark.parametrize("final", [False, True], ids=["step", "step_final"])
def test_fused_twin_and_jax_fused_agree(interp_full, final):
    jenv = rsoccer_tpu.make("VSS-v0")
    tenv = rsoccer_tpu_torch.make("VSS-v0")
    jenv.max_episode_steps = tenv.max_episode_steps = 4  # auto-resets in the window
    jful = JaxBatchedEnv(jenv, B, pallas_full=True, pallas_tile=B)
    kern = jful._full_final if final else jful._full
    fused = BatchedEnv(tenv, B, device="cpu", fused=True)
    twin = BatchedEnv(tenv, B, device="cpu")

    key = make_key(0, device="cpu")
    s_twin, o_twin = twin.reset(key.clone())
    s_fused, o_fused = fused.reset(key.clone())
    torch.testing.assert_close(o_twin, o_fused, rtol=0, atol=0)
    s_jax = jnp.asarray(s_fused.numpy())

    rng = np.random.default_rng(1)
    saw_done = False
    for t in range(6):
        act = rng.uniform(-1, 1, (2, B)).astype(np.float32)
        tn = np_noise(rng, jenv.transition_noise_spec(), B)
        rn = np_noise(rng, jenv.reset_noise_spec(), B)
        j_st, j_obs, j_aux = kern(
            s_jax, jnp.asarray(act),
            *jful._pack_noise({k: jnp.asarray(v) for k, v in tn.items()},
                              {k: jnp.asarray(v) for k, v in rn.items()}),
        )
        args = (torch.from_numpy(act), convert.noise_from_numpy(tn, device="cpu"), convert.noise_from_numpy(rn, device="cpu"))
        step = "step_final_with_noise" if final else "step_with_noise"
        f_out = getattr(fused, step)(s_fused, *args)
        t_out = getattr(twin, step)(s_twin, *args)
        s_jax, s_fused, s_twin = j_st, f_out[0], t_out[0]
        tag = f"step {t}"

        # the twin's structured state, packed, is the fused state
        np.testing.assert_allclose(
            pack_vss_state(s_twin).numpy(), s_fused.numpy(), atol=ATOL, err_msg=tag
        )
        np.testing.assert_allclose(s_fused.numpy(), np.asarray(j_st), atol=ATOL, err_msg=tag)
        j_obs = np.asarray(j_obs)  # (80, B) stacked obs, final obs on the fused path
        if final:
            f_obs = torch.cat(f_out[1:3]).numpy()
            t_obs = torch.cat(t_out[1:3]).numpy()
        else:
            f_obs, t_obs = f_out[1].numpy(), t_out[1].numpy()
        np.testing.assert_allclose(f_obs, j_obs, atol=ATOL, err_msg=tag)
        np.testing.assert_allclose(t_obs, f_obs, atol=ATOL, err_msg=tag)
        rew, term, trunc, info = f_out[-4:]
        np.testing.assert_allclose(rew.numpy(), np.asarray(j_aux[0]), atol=ATOL, err_msg=tag)
        np.testing.assert_array_equal(term.numpy(), np.asarray(j_aux[1]) > 0.5, err_msg=tag)
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(j_aux[2]) > 0.5, err_msg=tag)
        np.testing.assert_array_equal(t_out[-3].numpy(), term.numpy(), err_msg=tag)
        np.testing.assert_array_equal(t_out[-2].numpy(), trunc.numpy(), err_msg=tag)
        for k in info:
            np.testing.assert_allclose(t_out[-1][k].numpy(), info[k].numpy(), atol=ATOL, err_msg=tag)
        saw_done = saw_done or bool((term | trunc).any())
    assert saw_done


@pytest.mark.parametrize("fused_rng", ["input", "kernel"])
def test_rollout_is_deterministic(fused_rng):
    benv = rsoccer_tpu_torch.make_vec("VSS-v0", B, device="cpu", fused=True, fused_rng=fused_rng)
    roll = R.make_rollout_fn(benv, 12)
    c1, m1 = roll(R.init_carry(benv, seed=3))
    c2, m2 = roll(R.init_carry(benv, seed=3))
    c3, m3 = roll(R.init_carry(benv, seed=4))
    assert torch.equal(c1.state, c2.state) and torch.equal(c1.obs, c2.obs)
    assert torch.equal(c1.key, c2.key) and int(c1.key[2]) == 1 + 12
    for a, b in zip(m1, m2):
        assert torch.equal(a, b)
    assert not torch.equal(c1.state, c3.state)


def test_kernel_and_input_rng_modes_draw_one_stream():
    """On the port both fused_rng modes read the same Philox stream, so
    the same seed gives the same trajectory (unlike the TPU)."""
    outs = []
    for mode in ("input", "kernel"):
        benv = rsoccer_tpu_torch.make_vec("VSS-v0", B, device="cpu", fused=True, fused_rng=mode)
        outs.append(R.make_rollout_fn(benv, 8)(R.init_carry(benv, seed=6)))
    (c_in, m_in), (c_k, m_k) = outs
    assert torch.equal(c_in.state, c_k.state) and torch.equal(c_in.obs, c_k.obs)
    for a, b in zip(m_in, m_k):
        assert torch.equal(a, b)


def test_rollout_metrics_equal_per_step_sums():
    env = rsoccer_tpu_torch.make("VSS-v0")
    env.max_episode_steps = 5  # episodes end inside the window
    benv = BatchedEnv(env, B, device="cpu", fused=True, fused_rng="kernel")
    n_steps = 12
    _, got = R.make_rollout_fn(benv, n_steps)(R.init_carry(benv, seed=8))

    carry = R.init_carry(benv, seed=8)
    policy = R.uniform_policy(benv.action_size)
    tot_r, eps, ret_sum, len_sum = 0.0, 0, 0.0, 0.0
    ep_ret = np.zeros(B)
    ep_len = np.zeros(B)
    for _ in range(n_steps):
        act = policy(carry.pol_gen, carry.obs)
        st, obs, rew, term, trunc, _ = benv.step(carry.state, act, carry.key)
        done = (term | trunc).numpy()
        r = rew.double().numpy()
        ep_ret, ep_len = ep_ret + r, ep_len + 1
        tot_r += r.sum()
        eps += int(done.sum())
        ret_sum += ep_ret[done].sum()
        len_sum += ep_len[done].sum()
        ep_ret[done], ep_len[done] = 0.0, 0.0
        carry = carry._replace(state=st, obs=obs)
    assert eps > 0 and int(got.episodes) == eps
    assert float(got.total_reward) == pytest.approx(tot_r, abs=1e-3)
    assert float(got.episode_return_sum) == pytest.approx(ret_sum, abs=1e-3)
    assert float(got.episode_length_sum) == len_sum
    assert float(got.mean_episode_length) == pytest.approx(len_sum / eps)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
@pytest.mark.parametrize("shape", [(2, 4099), (5, 1024)], ids=["2x4099", "5x1024"])
def test_uniform_policy_draw_is_rand_times_two_minus_one(shape, seed):
    """The policy's one ``uniform_`` draw is the bits of ``rand * 2 - 1``
    and advances the generator alike."""
    g_new, g_old = (torch.Generator().manual_seed(seed) for _ in range(2))
    obs = torch.zeros((3, shape[1]))
    got = R.uniform_policy(shape[0])(g_new, obs)
    want = torch.rand(shape, generator=g_old) * 2.0 - 1.0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(g_new.get_state(), g_old.get_state())


def test_cpu_rollout_takes_the_plain_bookkeeping():
    """On the CPU no epilogue kernel is counted, and its wrappers refuse
    CPU tensors (nothing falls back)."""
    benv = rsoccer_tpu_torch.make_vec("VSS-v0", B, device="cpu", fused=True, fused_rng="kernel")
    before = tracing.snapshot()
    R.make_rollout_fn(benv, 3)(R.init_carry(benv, seed=2))
    assert tracing.launches(rollout_epilogue.WRAPPER, since=before) == 0
    z, t = torch.zeros(B), torch.zeros(B, dtype=torch.bool)
    acc = torch.zeros((rollout_epilogue.N_SUMS, rollout_epilogue.SLOTS), dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        rollout_epilogue.epilogue(z, t, t, z, z, acc, first=True)
    with pytest.raises(NotImplementedError):
        rollout_epilogue.finish(acc, B)


def test_twin_rollout_runs_and_stays_in_bounds():
    benv = rsoccer_tpu_torch.make_vec("VSS-v0", B, device="cpu")
    carry, ms = R.make_rollout_fn(benv, 10)(R.init_carry(benv, seed=1))
    assert carry.obs.shape == (40, B)
    assert bool(torch.isfinite(carry.obs).all())
    assert float(carry.obs.abs().max()) <= float(np.float32(1.2))
    leaves = tree_map(lambda t: bool(torch.isfinite(t.float()).all()), carry.state)
    assert all(jax.tree.leaves(leaves))
    assert torch.isfinite(ms.total_reward)
