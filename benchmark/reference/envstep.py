"""The reference's env step: ``reset`` and ``step`` of one configuration
from a Philox key, in blocks of envs.

The key is the batch's ``[k0, k1, step]`` before the call; neither function
advances the caller's key.  ``env_base`` is the global index of the first
env of a block, so a block of columns draws the words those columns of the
whole batch draw.
"""

from __future__ import annotations

import torch

from benchmark.reference.envs.base import draw_noise, step_noise_spec
from benchmark.reference.envs.ssl_static_defenders import SSLStaticDefendersEnv
from benchmark.reference.envs.vss import VSSEnv

ENVS = {"VSS-v0": VSSEnv, "SSLStaticDefenders-v0": SSLStaticDefendersEnv}


def make(env_id: str, **kwargs):
    return ENVS[env_id](**kwargs)


def reset(env, key: torch.Tensor, batch: int, env_base: int = 0):
    """(state, obs) of ``batch`` envs from global index ``env_base`` on."""
    noise = draw_noise(key.clone(), env.reset_noise_spec(), batch, env_base)
    state = env.reset_state(noise)
    return state, env.observe(state)


def noise(env, key: torch.Tensor, batch: int, env_base: int = 0):
    """One step's (transition, reset) noise blocks at ``key``'s step."""
    drawn = draw_noise(key.clone(), step_noise_spec(env), batch, env_base)
    return ({k: drawn[k] for k in env.transition_noise_spec()},
            {k: drawn[k] for k in env.reset_noise_spec()})


def step(env, state, action, key: torch.Tensor, env_base: int = 0):
    """One auto-resetting step: (state, obs, reward, terminated, truncated,
    info) for the columns of ``state`` from global index ``env_base`` on."""
    return env.step_with_noise(state, action, *noise(env, key, action.shape[-1], env_base))


def step_final(env, state, action, key: torch.Tensor, env_base: int = 0):
    """:func:`step` with the final pre-reset obs: (state, obs, final obs,
    reward, terminated, truncated)."""
    st, obs, fobs, rew, term, trunc, _ = env.step_with_noise_final(
        state, action, *noise(env, key, action.shape[-1], env_base))
    return st, obs, fobs, rew, term, trunc
