"""The port's VSSMultiAgent-v0 (``rsoccer_tpu_torch/envs/vss_multiagent.py``)
held against the JAX package's on the CPU: reset and observe, the step
through auto-resets on the unfused path and on the ``fused_physics``
path's plain version (which the card runs through K2), both fed the same
seeded noise; the league checkpoints it scores, loaded without jax; and
the anchor tool on it.  B = 16."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.tools import vss_anchor_eval
from tests.test_torch_env_vss import assert_states_close, np_noise, vm

torch.set_num_threads(1)

MA = "VSSMultiAgent-v0"
B = 16
ATOL = 5e-5  # tests/test_torch_env_vss.py's
ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts")
LEAGUE = ("selfplay_vss_r3", "selfplay_vss_mix")


def pair(env_id, max_steps=None):
    jenv, tenv = rsoccer_tpu.make(env_id), rsoccer_tpu_torch.make(env_id)
    if max_steps is not None:
        jenv.max_episode_steps = tenv.max_episode_steps = max_steps
    return jenv, tenv


def jnp_noise(noise):
    return {k: jnp.asarray(v) for k, v in noise.items()}


def policy_actions(rng, obs, n_act):
    """Actions a policy could give: a fixed linear map of the obs through
    tanh, with noise, so every wheel moves and some saturate."""
    w = np.random.default_rng(99).normal(size=(n_act, obs.shape[0])).astype(np.float32)
    return np.clip(np.tanh(1.5 * w @ obs) + 0.3 * rng.normal(size=(n_act, obs.shape[1])), -1, 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_env_fns(env_id, max_steps, final):
    """The JAX env and its compiled batched step (one compile for both of
    the port's paths)."""
    jenv = rsoccer_tpu.make(env_id)
    if max_steps is not None:
        jenv.max_episode_steps = max_steps
    return jenv, jax.jit(vm(jenv.step_with_noise_final if final else jenv.step_with_noise))


def check_env_against_jax(env_id, fused_physics, final, max_steps, n_steps=8, seed=0):
    """``env_id``'s step_with_noise(_final) through auto-resets: the port's
    BatchedEnv (unfused, or ``fused_physics`` on the CPU: its plain
    version) against the JAX env's XLA step, the same noise and actions."""
    jenv, j_fn = jax_env_fns(env_id, max_steps, final)
    tenv = rsoccer_tpu_torch.make(env_id)
    if max_steps is not None:
        tenv.max_episode_steps = max_steps
    benv = BatchedEnv(tenv, B, device="cpu", fused_physics=fused_physics)
    rng = np.random.default_rng(seed)
    r0 = np_noise(rng, jenv.reset_noise_spec(), B)
    js = vm(jenv.reset_state)(jnp_noise(r0))
    ts = tenv.reset_state(convert.noise_from_numpy(r0, device="cpu"))
    assert_states_close(ts, js, atol=0)
    obs = np.asarray(vm(jenv.observe)(js))
    np.testing.assert_allclose(tenv.observe(ts).numpy(), obs, atol=1e-6)  # a fresh observation
    t_fn = benv.step_final_with_noise if final else benv.step_with_noise
    dones = 0
    for t in range(n_steps):
        act = policy_actions(rng, obs, tenv.action_size)
        tn = np_noise(rng, jenv.transition_noise_spec(), B)
        rn = np_noise(rng, jenv.reset_noise_spec(), B)
        jo = j_fn(js, jnp.asarray(act), jnp_noise(tn), jnp_noise(rn))
        to = t_fn(ts, torch.from_numpy(act), convert.noise_from_numpy(tn, device="cpu"),
                  convert.noise_from_numpy(rn, device="cpu"))
        js, ts = jo[0], to[0]
        tag = f"{env_id} fused_physics={fused_physics} step {t}"
        assert_states_close(ts, js, tag=tag)
        n_obs = 2 if final else 1
        for k in range(1, 1 + n_obs):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=ATOL, err_msg=tag)
        rew, term, trunc, info = to[1 + n_obs:]
        j_rew, j_term, j_trunc, j_info = jo[1 + n_obs:]
        np.testing.assert_allclose(rew.numpy(), np.asarray(j_rew), atol=ATOL, err_msg=tag)
        np.testing.assert_array_equal(term.numpy(), np.asarray(j_term), err_msg=tag)
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(j_trunc), err_msg=tag)
        assert set(info) == set(j_info)
        for k in info:
            np.testing.assert_allclose(info[k].numpy(), np.asarray(j_info[k]), atol=ATOL, err_msg=f"{tag} {k}")
        obs = np.asarray(jo[1])
        dones += int((term | trunc).sum())
    return dones


@pytest.mark.parametrize("final", [False, True], ids=["step", "step_final"])
@pytest.mark.parametrize("fused_physics", [False, True], ids=["unfused", "fused_physics"])
def test_step_matches_jax_through_resets(fused_physics, final):
    assert check_env_against_jax(MA, fused_physics, final, max_steps=3) >= B


def test_step_matches_jax_at_the_reference_limit():
    check_env_against_jax(MA, True, False, max_steps=None, n_steps=6, seed=3)


def test_action_layout_and_ou_yellows():
    """Each blue robot reads its own two action rows (robot-major), the
    yellows the OU process's rows, as the JAX pre_physics."""
    jenv, tenv = pair(MA)
    assert (tenv.action_size, tenv.obs_size) == (jenv.action_size, jenv.obs_size) == (6, 40)
    assert tenv.transition_noise_spec() == jenv.transition_noise_spec()
    rng = np.random.default_rng(5)
    st = tenv.reset_state(convert.noise_from_numpy(np_noise(rng, jenv.reset_noise_spec(), B), device="cpu"))
    st = st._replace(ou_x=torch.from_numpy(rng.normal(size=(6, 2, B)).astype(np.float32)))
    act = rng.uniform(-1, 1, (6, B)).astype(np.float32)
    noise = np_noise(rng, jenv.transition_noise_spec(), B)
    cmd, (ou_x, wl, wr) = tenv.pre_physics(st, torch.from_numpy(act), convert.noise_from_numpy(noise, "cpu"))
    j_cmd, (j_ou, j_wl, j_wr) = vm(jenv.pre_physics)(
        jax.tree.map(jnp.asarray, convert.state_to_numpy(st)), jnp.asarray(act), jnp_noise(noise))
    for got, want in ((wl, j_wl), (wr, j_wr), (ou_x, j_ou)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # robot 1's left wheel follows action row 2
    w1, _ = tenv._actions_to_wheels(torch.from_numpy(act).reshape(3, 2, B))
    np.testing.assert_array_equal(wl[1].numpy(), w1[1].numpy())


def test_fused_kernels_refused_and_cuda_default():
    """The fused kernels take only the exact env types: both extensions run
    their physics through K2 (``fused_physics``) and nothing else; without
    a card the default device raises."""
    for env_id in (MA, "VSSSelfPlay-v0"):
        with pytest.raises(NotImplementedError, match="exact types"):
            rsoccer_tpu_torch.make_vec(env_id, 8, device="cpu", fused=True)
        assert rsoccer_tpu_torch.make_vec(env_id, 8, device="cpu", fused_physics=True).fused_physics
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rsoccer_tpu_torch.make_vec(MA, 8).reset(torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("name", LEAGUE)
def test_league_checkpoints_load(name):
    """The two league policies: 16 leaves, obs 40, actions 6, loaded
    through load_ppo_checkpoint unchanged, the same policy as the JAX
    package's f32 apply on a batch of obs (bf16 towers: 1e-3)."""
    from rsoccer_tpu.models import networks as jnet
    from rsoccer_tpu.models.ppo import ObsNorm as JaxObsNorm
    from rsoccer_tpu.utils import checkpoint as jckpt

    path = os.path.join(ARTIFACTS, f"{name}.ckpt.npz")
    net, obs_norm = convert.load_ppo_checkpoint(path, device="cpu")
    assert (net.obs_size, net.action_size, net.hidden) == (40, 6, (256, 256))
    jn = jnet.ActorCritic(action_size=6)
    like = {"params": jn.init(jax.random.PRNGKey(0), jnp.zeros((1, 40))), "obs_norm": JaxObsNorm.init(40)}
    ck = jckpt.restore(path, like=like)
    obs = np.random.default_rng(1).uniform(-1.2, 1.2, (64, 40)).astype(np.float32)
    want = np.asarray(jn.apply(ck["params"], ck["obs_norm"].normalize(jnp.asarray(obs)))[0])
    with torch.no_grad():
        got = net.policy_mean(obs_norm.normalize(torch.from_numpy(obs))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_unpublished_league_checkpoint_is_refused():
    """artifacts/selfplay_vss.ckpt.npz holds the params alone (13 leaves,
    no obs_norm): not a {params, obs_norm} checkpoint."""
    with pytest.raises(ValueError, match="this one has 13"):
        convert.load_ppo_checkpoint(os.path.join(ARTIFACTS, "selfplay_vss.ckpt.npz"), device="cpu")


def test_anchor_tool_on_the_league_env(capsys):
    path = os.path.join(ARTIFACTS, "selfplay_vss_r3.ckpt.npz")
    vss_anchor_eval.main(["--env-id", MA, "--params", path, "--envs", "8", "--steps", "4",
                          "--device", "cpu", "--fused-physics"])
    out = json.loads(capsys.readouterr().out)
    assert out["env_id"] == MA and out["fused_physics"] and not out["fused"]
    with pytest.raises(SystemExit):
        vss_anchor_eval.main(["--env-id", MA, "--params", path, "--device", "cpu", "--fused"])
    assert "VSS-v0's whole-step kernel" in capsys.readouterr().err
    with pytest.raises(SystemExit):  # a single-agent policy on the three-blue env
        vss_anchor_eval.main(["--env-id", MA, "--params", os.path.join(ARTIFACTS, "vss_ppo.ckpt.npz"),
                              "--envs", "8", "--steps", "1", "--device", "cpu"])
