"""Rollout loop: a Python loop over batched env steps.

Port of ``rsoccer_tpu/batch/rollout.py``.  The JAX package scans the step
inside one compiled program; here each step is launched from the host,
with every metric summed on the device and no host sync inside the loop
(nothing reads a value back until the caller does).  Capturing the loop
as a CUDA graph is a later step (ROADMAP.md).

:func:`make_rollout_fn`'s bookkeeping (the episode accumulators and the
metric sums) takes one of two paths, by the carry's device: on the card
one kernel a step and one a call (``ops/rollout_epilogue.py``), on the
CPU the plain torch ops of :func:`make_step_fn` with
:func:`rollout_metrics`, the kernel's plain version.

RNG: the env key is the batch's Philox key (advanced by every step); the
policy draws from its own ``torch.Generator`` on the same device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.core.state import tree_map
from rsoccer_tpu_torch.ops import rollout_epilogue
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.utils import tracing


class RolloutCarry(NamedTuple):
    state: object  # batched env state (batch-last leaves, or packed (S, B))
    obs: torch.Tensor  # (obs_size, B)
    key: torch.Tensor  # env Philox key [k0, k1, step]
    pol_gen: torch.Generator  # policy random stream
    ep_return: torch.Tensor  # (B,) running return of the current episode
    ep_length: torch.Tensor  # (B,) running length of the current episode


class RolloutMetrics(NamedTuple):
    total_reward: torch.Tensor  # scalar — summed over steps and envs
    episodes: torch.Tensor  # scalar — number of episode ends observed
    episode_return_sum: torch.Tensor  # scalar — sum of completed returns
    episode_length_sum: torch.Tensor  # scalar — sum of completed lengths

    @property
    def mean_episode_return(self):
        return self.episode_return_sum / torch.clamp_min(self.episodes, 1)

    @property
    def mean_episode_length(self):
        return self.episode_length_sum / torch.clamp_min(self.episodes, 1)


def init_carry(benv: BatchedEnv, seed: int) -> RolloutCarry:
    dev = benv.device
    key = make_key(seed, stream=0, device=dev)
    state, obs = benv.reset(key)
    pol_gen = torch.Generator(device=dev)
    pol_gen.manual_seed(seed)
    b = benv.n_envs
    zeros = torch.zeros((b,), device=dev)
    return RolloutCarry(state, obs, key, pol_gen, zeros, zeros.clone())


def uniform_policy(action_size: int):
    """Random policy in [-1, 1]: ``policy(gen, obs) -> (A, B)``.  One
    draw, the bits of ``torch.rand(...) * 2 - 1`` with the generator
    advanced alike (``parallel/rollout.sharded_uniform_policy`` draws
    that way)."""

    def policy(gen, obs):
        return torch.empty((action_size, obs.shape[-1]), device=obs.device).uniform_(
            -1.0, 1.0, generator=gen
        )

    return policy


def _act_and_step(benv: BatchedEnv, policy: Callable, carry: RolloutCarry):
    """The policy's draw and the env step of one rollout step."""
    with tracing.span(tracing.POLICY):
        actions = policy(carry.pol_gen, carry.obs)
    return benv.step(carry.state, actions, carry.key)


def make_step_fn(benv: BatchedEnv, policy: Callable, metrics_fn: Callable):
    """One rollout step: ``one_step(carry) -> (carry, metrics)``.

    ``metrics_fn(reward, done, ep_ret, ep_len, info)`` computes the step's
    metrics from the PRE-reset episode accumulators; the carry's
    accumulators are zeroed on done lanes afterwards.
    """

    def one_step(carry: RolloutCarry):
        state, obs, reward, term, trunc, info = _act_and_step(benv, policy, carry)
        done = term | trunc
        ep_ret = carry.ep_return + reward
        ep_len = carry.ep_length + 1.0
        metrics = metrics_fn(reward, done, ep_ret, ep_len, info)
        ep_ret = torch.where(done, 0.0, ep_ret)
        ep_len = torch.where(done, 0.0, ep_len)
        return (
            RolloutCarry(state, obs, carry.key, carry.pol_gen, ep_ret, ep_len),
            metrics,
        )

    return one_step


def rollout_metrics(reward, done, ep_ret, ep_len, info) -> RolloutMetrics:
    return RolloutMetrics(
        total_reward=reward.sum(),
        episodes=done.sum(),
        episode_return_sum=torch.where(done, ep_ret, 0.0).sum(),
        episode_length_sum=torch.where(done, ep_len, 0.0).sum(),
    )


def make_rollout_fn(benv: BatchedEnv, n_steps: int, policy: Callable | None = None):
    """Build ``rollout(carry) -> (carry, metrics)`` running ``n_steps``
    batched steps; the metrics are device scalars summed over the steps.
    Each step, its bookkeeping included, is a ``rsoccer.rollout.step``
    span and its policy call a ``rsoccer.policy`` span (``utils/tracing``).
    A carry on the card takes the epilogue kernel (its sums in float64,
    finished once a call), one on the CPU the plain torch bookkeeping.

    ``policy(gen, obs) -> actions`` sees obs ``(obs_size, B)`` and returns
    ``(action_size, B)``.
    """
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if policy is None:
        policy = uniform_policy(benv.action_size)
    one_step = make_step_fn(benv, policy, rollout_metrics)

    def plain(carry: RolloutCarry):
        with tracing.span(tracing.ROLLOUT_STEP):
            carry, total = one_step(carry)
        for _ in range(n_steps - 1):
            with tracing.span(tracing.ROLLOUT_STEP):
                carry, m = one_step(carry)
                total = tree_map(torch.add, total, m)
        return carry, total

    def on_card(carry: RolloutCarry):
        acc = rollout_epilogue.scratch(carry.ep_return.device)
        for i in range(n_steps):
            with tracing.span(tracing.ROLLOUT_STEP):
                state, obs, reward, term, trunc, _ = _act_and_step(benv, policy, carry)
                ep_ret, ep_len = rollout_epilogue.epilogue(
                    reward, term, trunc, carry.ep_return, carry.ep_length, acc, first=i == 0
                )
                carry = RolloutCarry(state, obs, carry.key, carry.pol_gen, ep_ret, ep_len)
        return carry, RolloutMetrics(*rollout_epilogue.finish(acc, carry.ep_return.shape[-1]))

    def rollout(carry: RolloutCarry):
        return on_card(carry) if carry.ep_return.is_cuda else plain(carry)

    return rollout
