"""Evaluation: deterministic-policy rollouts with per-task success metrics.

Port of ``rsoccer_tpu/eval.py``.  Success criteria, from each task's own
terminal semantics:

  VSS-v0                      scored a goal (info ``goals_blue``)
  VSSMultiAgent-v0            scored a goal (info ``goals_blue``)
  VSSSelfPlay-v0              scored a goal (info ``goals_blue``)
  SSLStaticDefenders-v0       scored a goal (info ``goal``)
  SSLContestedPossession-v0   scored a goal (info ``goal``)
  SSLDribbling-v0             passed all 7 checkpoints: the episode return
                              is the checkpoint count (+1 each)
  SSLPassEndurance-v0         pass received: the only +1 terminal reward

The evaluation is a Python loop of batched steps on the env's device
(``batch/rollout.make_step_fn``); the metrics are device scalars summed
over the steps, read back once by the caller.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from rsoccer_tpu_torch.batch import rollout as R
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.core.state import tree_map
from rsoccer_tpu_torch.models.networks import check_device
from rsoccer_tpu_torch.registry import make


class EvalMetrics(NamedTuple):
    episodes: torch.Tensor  # completed episodes observed
    successes: torch.Tensor  # of those, how many met the task's success test
    total_reward: torch.Tensor
    episode_return_sum: torch.Tensor  # over completed episodes
    episode_length_sum: torch.Tensor

    @property
    def success_rate(self):
        return self.successes / torch.clamp_min(self.episodes, 1)

    @property
    def mean_episode_return(self):
        return self.episode_return_sum / torch.clamp_min(self.episodes, 1)

    @property
    def mean_episode_length(self):
        return self.episode_length_sum / torch.clamp_min(self.episodes, 1)

    def summary(self) -> dict:
        return {
            "episodes": int(self.episodes),
            "successes": int(self.successes),
            "success_rate": float(self.success_rate),
            "mean_episode_return": float(self.mean_episode_return),
            "mean_episode_length": float(self.mean_episode_length),
        }


# success(reward, ep_return, info) -> (B,) bool, evaluated on done lanes only.
SuccessFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]


def _goal_from_info(key):
    def fn(reward, ep_return, info):
        return info[key] > 0.5

    return fn


_SUCCESS: dict[str, SuccessFn] = {
    "VSS-v0": _goal_from_info("goals_blue"),
    "VSSMultiAgent-v0": _goal_from_info("goals_blue"),
    "VSSSelfPlay-v0": _goal_from_info("goals_blue"),
    "SSLStaticDefenders-v0": _goal_from_info("goal"),
    "SSLContestedPossession-v0": _goal_from_info("goal"),
    # +1 per checkpoint; 7 checkpoints completes the course
    "SSLDribbling-v0": lambda reward, ep_return, info: ep_return >= 6.5,
    # terminal +1 only on a received pass (shaping |ball_grad| << 1 per step)
    "SSLPassEndurance-v0": lambda reward, ep_return, info: reward > 0.99,
}


def success_criterion(env_id: str) -> SuccessFn:
    try:
        return _SUCCESS[env_id]
    except KeyError:
        raise KeyError(
            f"no success criterion registered for {env_id!r}; "
            f"known: {sorted(_SUCCESS)}"
        ) from None


def make_metrics_fn(success: SuccessFn):
    """``metrics_fn(reward, done, ep_ret, ep_len, info) -> EvalMetrics`` of
    one step, for ``batch/rollout.make_step_fn``."""

    def metrics_fn(reward, done, ep_ret, ep_len, info):
        won = done & success(reward, ep_ret, info)
        return EvalMetrics(
            episodes=done.sum(),
            successes=won.sum(),
            total_reward=reward.sum(),
            episode_return_sum=torch.where(done, ep_ret, 0.0).sum(),
            episode_length_sum=torch.where(done, ep_len, 0.0).sum(),
        )

    return metrics_fn


def make_eval_fn(
    benv: BatchedEnv,
    n_steps: int,
    policy: Callable,
    success: SuccessFn,
    carry_init: Callable | None = None,
):
    """Build ``evaluate(seed) -> EvalMetrics``: a fresh reset, ``n_steps``
    batched steps, deterministic given the seed.

    ``carry_init``: a transform of the freshly reset ``RolloutCarry``, e.g.
    self-play's swap of a given frozen-opponent payload into the env
    state before the first step."""
    one_step = R.make_step_fn(benv, policy, make_metrics_fn(success))

    def evaluate(seed: int) -> EvalMetrics:
        carry = R.init_carry(benv, seed)
        if carry_init is not None:
            carry = carry_init(carry)
        carry, total = one_step(carry)
        for _ in range(n_steps - 1):
            carry, m = one_step(carry)
            total = tree_map(torch.add, total, m)
        return total

    return evaluate


def evaluate_policy(
    env_id: str,
    policy: Callable,
    n_envs: int = 256,
    n_steps: int | None = None,
    seed: int = 0,
    *,
    device="cuda",
    fused: bool = False,
    **env_kwargs,
) -> dict:
    """One-call evaluation: metrics dict for ``policy`` on ``env_id``.

    ``n_steps`` defaults to 2x the env's episode limit so every env
    completes at least one episode.  ``policy(gen, obs (O, B)) -> actions
    (A, B)``.  ``fused`` steps through the env's fused kernel, which draws
    the env noise itself (``fused_rng="kernel"``)."""
    success = success_criterion(env_id)
    device = check_device(device)
    env = make(env_id, **env_kwargs)
    benv = BatchedEnv(env, n_envs, device=device, fused=fused, fused_rng="kernel")
    if n_steps is None:
        n_steps = 2 * env.max_episode_steps
    out = make_eval_fn(benv, n_steps, policy, success)(seed).summary()
    out.update(env_id=env_id, n_envs=n_envs, n_steps=n_steps, device=str(benv.device),
               fused=fused)
    return out
