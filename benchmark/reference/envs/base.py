"""Functional environment interface: noise-as-input, auto-reset.

Port of ``rsoccer_tpu/envs/base.py``.  An env holds only static Python
constants; its dynamics are deterministic functions of pre-drawn noise:

    transition_noise_spec() -> {name: (shape, "uniform"|"normal")}
    reset_noise_spec()      -> {name: (shape, "uniform"|"normal")}
    reset_state(noise)              -> state
    transition(state, act, noise)   -> (state, reward, terminated, info)
    observe(state)                  -> obs

All of them work on batch-last tensors (every leaf ends in the env batch
``B``), which is what the JAX package's ``vmap(..., in_axes=-1)`` makes of
its single-env functions.

Randomness: :func:`draw_noise` fills every block of a spec from the port's
one Philox stream (``ops/philox.py``).  Uniform blocks take slots in spec
order; each normal takes two further uniforms, all ``u1`` first, then all
``u2`` (Box-Muller).  The batched env draws a step's reset and transition
blocks as ONE spec, reset blocks first, so for VSS the slots are exactly
those the fused kernel draws in-kernel: spawn, theta, OU ``u1``, OU ``u2``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.core.state import tree_map
from benchmark.reference.ops.philox import (
    box_muller, philox_words, uniforms_from_words,
)

NoiseSpec = Dict[str, Tuple[Tuple[int, ...], str]]


def _flat_sizes(spec: NoiseSpec, kind: str):
    return [
        (name, shape, math.prod(shape))
        for name, (shape, k) in spec.items()
        if k == kind
    ]


def step_noise_spec(env) -> NoiseSpec:
    """A step's reset and transition blocks as one spec, reset first — the
    slot order a step draws in (for VSS: spawn, theta, OU u1, OU u2, which
    the fused kernel draws in-kernel in the same order)."""
    return {**env.reset_noise_spec(), **env.transition_noise_spec()}


def draw_noise(key: torch.Tensor, spec: NoiseSpec, batch: int, env_base: int = 0):
    """Draw every block of ``spec`` for the ``batch`` envs from global env
    index ``env_base`` on at ``key``'s step, each block with a trailing
    batch axis, then advance ``key``'s step.  At ``env_base`` b the blocks
    are columns ``[b, b + batch)`` of an unsharded batch's.

    An empty spec still advances the key (one key schedule whatever a task
    draws) and returns the JAX package's pad block ``{"_pad": (1, B)}``
    zeros, from which a deterministic reset takes its batch."""
    if not spec:
        key[2:].add_(1)
        return {"_pad": torch.zeros((1, batch), device=key.device)}
    uni = _flat_sizes(spec, "uniform")
    nrm = _flat_sizes(spec, "normal")
    n_u = sum(s for _, _, s in uni)
    n_n = sum(s for _, _, s in nrm)
    u = uniforms_from_words(philox_words(key, n_u + 2 * n_n, batch, env_base=env_base))
    key[2:].add_(1)
    out = {}
    off = 0
    for name, shape, size in uni:
        out[name] = u[off : off + size].reshape(shape + (batch,))
        off += size
    normals = box_muller(u[n_u : n_u + n_n], u[n_u + n_n :])
    off = 0
    for name, shape, size in nrm:
        out[name] = normals[off : off + size].reshape(shape + (batch,))
        off += size
    return out


def select(done, if_done, if_not):
    """Leafwise ``where(done, if_done, if_not)``; ``done`` is (B,)."""
    return tree_map(lambda r, n: torch.where(done, r, n), if_done, if_not)


class Env:
    """Base class — subclasses define obs_size/action_size/max_episode_steps
    and implement the noise-spec'd hooks above."""

    obs_size: int
    action_size: int
    max_episode_steps: int

    def transition_noise_spec(self) -> NoiseSpec:
        return {}

    def reset_noise_spec(self) -> NoiseSpec:
        return {}

    def reset_state(self, noise):
        raise NotImplementedError

    def transition(self, state, action, noise):
        """-> (next_state, reward, terminated, info)."""
        raise NotImplementedError

    def observe(self, state) -> torch.Tensor:
        raise NotImplementedError

    def step_with_noise(self, state, action, t_noise, r_noise):
        """transition + TimeLimit truncation + auto-reset.  Done lanes
        return a freshly reset state and its obs; reward, flags and info
        still describe the ending step."""
        ns, reward, terminated, info = self.transition(state, action, t_noise)
        # gymnasium's TimeLimit truncates independently of terminated
        truncated = ns.steps >= self.max_episode_steps
        done = terminated | truncated
        out_state = select(done, self.reset_state(r_noise), ns)
        return out_state, self.observe(out_state), reward, terminated, truncated, info

    def step_with_noise_final(self, state, action, t_noise, r_noise):
        """Like :meth:`step_with_noise`, plus the FINAL (pre-reset) obs.

        Returns (state, obs, final_obs, reward, terminated, truncated, info).
        """
        ns, reward, terminated, info = self.transition(state, action, t_noise)
        truncated = ns.steps >= self.max_episode_steps
        done = terminated | truncated
        final_obs = self.observe(ns)
        out_state = select(done, self.reset_state(r_noise), ns)
        return (
            out_state, self.observe(out_state), final_obs,
            reward, terminated, truncated, info,
        )
