"""The port's evaluation (``rsoccer_tpu_torch/eval.py``) and VSS anchor
(``rsoccer_tpu_torch/tools/vss_anchor_eval.py``) against the JAX
package's: the success criteria and per-step metrics on fixed arrays, the
ids not yet ported, and small evaluations on the CPU."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu.eval as jeval
import rsoccer_tpu_torch
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch import eval as teval
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.models.ppo import make_policy
from rsoccer_tpu_torch.tools import vss_anchor_eval

torch.set_num_threads(1)

PORTED = ["VSS-v0", "SSLStaticDefenders-v0", "SSLContestedPossession-v0", "SSLDribbling-v0",
          "SSLPassEndurance-v0"]
B = 64
VSS_PPO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "artifacts", "vss_ppo.ckpt.npz")


def fixed_step(seed):
    """A step's (reward, done, ep_ret, ep_len, info) with every info key the
    criteria read, and values on both sides of each threshold."""
    rng = np.random.default_rng(seed)
    reward = rng.choice([-1.0, -0.2, 0.5, 0.99, 0.995, 1.0], B).astype(np.float32)
    done = rng.uniform(size=B) < 0.5
    ep_ret = rng.choice([0.0, 3.0, 6.49, 6.5, 7.0], B).astype(np.float32)
    ep_len = rng.integers(1, 1200, B).astype(np.float32)
    info = {k: rng.choice([0.0, 0.4, 0.6, 1.0], B).astype(np.float32) for k in ("goals_blue", "goal")}
    return reward, done, ep_ret, ep_len, info


def jax_metrics_fn(monkeypatch, success):
    """The JAX package's per-step eval metrics, as make_eval_fn builds them."""
    seen = {}

    def capture(benv, policy, metrics_fn):
        seen["fn"] = metrics_fn
        return lambda carry, _: None

    monkeypatch.setattr(jeval.R, "make_step_fn", capture)
    jeval.make_eval_fn(None, 1, None, success)
    return seen["fn"]


@pytest.mark.parametrize("env_id", PORTED)
def test_success_and_metrics_match_jax(monkeypatch, env_id):
    j_fn = jax_metrics_fn(monkeypatch, jeval.success_criterion(env_id))
    t_fn = teval.make_metrics_fn(teval.success_criterion(env_id))
    for seed in range(3):
        reward, done, ep_ret, ep_len, info = fixed_step(seed)
        want = j_fn(*(jnp.asarray(a) for a in (reward, done, ep_ret, ep_len)),
                    {k: jnp.asarray(v) for k, v in info.items()})
        got = t_fn(*(torch.from_numpy(a) for a in (reward, done, ep_ret, ep_len)),
                   {k: torch.from_numpy(v) for k, v in info.items()})
        np.testing.assert_array_equal(
            teval.success_criterion(env_id)(torch.from_numpy(reward), torch.from_numpy(ep_ret),
                                            {k: torch.from_numpy(v) for k, v in info.items()}).numpy(),
            np.asarray(jeval.success_criterion(env_id)(jnp.asarray(reward), jnp.asarray(ep_ret),
                                                       {k: jnp.asarray(v) for k, v in info.items()})))
        for name, g, w in zip(teval.EvalMetrics._fields, got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=0, atol=1e-4, err_msg=name)
        assert int(got.successes) > 0 or env_id == "SSLPassEndurance-v0"


@pytest.mark.parametrize("env_id", ["VSSMultiAgent-v0", "VSSSelfPlay-v0"])
def test_not_ported_ids_raise(env_id):
    """The two ids that were not ported until the multi-agent and
    self-play slice now resolve to the JAX package's criterion (a blue
    goal); an unknown id still raises."""
    info = {"goals_blue": torch.tensor([1.0, 0.0, 1.0])}
    got = teval.success_criterion(env_id)(torch.zeros(3), torch.zeros(3), info)
    want = jeval.success_criterion(env_id)(jnp.zeros(3), jnp.zeros(3), {"goals_blue": jnp.asarray([1.0, 0.0, 1.0])})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(KeyError):
        teval.success_criterion("NoSuchEnv-v0")


def test_eval_metrics_properties():
    m = teval.EvalMetrics(*(torch.tensor(v) for v in (4, 3, 2.0, 6.0, 40.0)))
    assert m.summary() == {"episodes": 4, "successes": 3, "success_rate": 0.75,
                           "mean_episode_return": 1.5, "mean_episode_length": 10.0}
    empty = teval.EvalMetrics(*(torch.tensor(v) for v in (0, 0, 0.0, 0.0, 0.0)))
    assert empty.summary()["success_rate"] == 0.0


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_evaluate_policy_on_the_cpu(fused):
    net, obs_norm = convert.load_ppo_checkpoint(VSS_PPO, device="cpu")
    env = rsoccer_tpu_torch.make("VSS-v0")
    env.max_episode_steps = 20
    benv = BatchedEnv(env, 32, device="cpu", fused=fused, fused_rng="kernel")
    policy = make_policy(net, obs_norm)
    ms = teval.make_eval_fn(benv, 30, policy, teval.success_criterion("VSS-v0"))(0)
    out = ms.summary()
    assert out["episodes"] >= 32 and 0.0 <= out["success_rate"] <= 1.0
    assert out["mean_episode_length"] <= 20.0
    again = teval.make_eval_fn(benv, 30, policy, teval.success_criterion("VSS-v0"))(0)
    assert again.summary() == out
    one = teval.evaluate_policy("VSS-v0", policy, n_envs=8, n_steps=5, device="cpu", fused=fused)
    assert one["n_steps"] == 5 and one["device"] == "cpu" and one["fused"] is fused


def test_evaluate_policy_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.evaluate_policy("VSS-v0", lambda gen, obs: obs[:2], n_envs=8, n_steps=2)


def test_anchor_eval_counts_goals_and_truncations(capsys):
    net, obs_norm = convert.load_ppo_checkpoint(VSS_PPO, device="cpu")
    env = rsoccer_tpu_torch.make("VSS-v0")
    env.max_episode_steps = 30
    benv = BatchedEnv(env, 32, device="cpu", fused=True, fused_rng="kernel")
    out = vss_anchor_eval.anchor_eval(benv, make_policy(net, obs_norm), 70, seed=123)
    assert out["episodes"] >= 64
    # VSS episodes end on a goal or the time limit (a goal on the limit's
    # step counts for both)
    assert out["blue_goal_rate"] + out["yellow_goal_rate"] <= 1.0
    assert out["blue_goal_rate"] + out["yellow_goal_rate"] + out["truncation_rate"] >= 1.0
    assert out["truncation_rate"] > 0.0
    assert out["mean_goal_diff"] == pytest.approx(out["blue_goal_rate"] - out["yellow_goal_rate"])
    vss_anchor_eval.main(["--params", VSS_PPO, "--envs", "8", "--steps", "5",
                          "--device", "cpu", "--fused"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["env_id"] == "VSS-v0" and printed["episodes"] >= 0
