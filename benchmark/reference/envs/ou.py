"""Ornstein-Uhlenbeck action noise as explicit state.

Port of ``rsoccer_tpu/envs/ou.py`` (reference Utils/Utils.py:5-29): the
process state lives in the env state and each step advances it from a
pre-drawn standard-normal block.  :func:`ou_step` and :func:`ou_reset` are
the keyed conveniences over it: they draw from the port's Philox key
(``ops/philox.make_key``), so their numbers are not ``jax.random``'s.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.envs.base import draw_noise

OU_THETA = 0.17  # reference Utils/Utils.py:6


def ou_update(x_prev, noise, dt: float, mu: float = 0.0, sigma: float = 0.5):
    """One Euler-Maruyama OU update from pre-drawn ``noise``; any shape."""
    return x_prev + OU_THETA * (mu - x_prev) * dt + sigma * math.sqrt(dt) * noise


def ou_step(x_prev, key, dt: float, mu: float = 0.0, sigma: float = 0.5):
    """:func:`ou_update` with standard normals drawn at ``key``'s step,
    which advances.  ``x_prev`` is batch-last (``(..., B)``): column ``b``
    draws env ``b``'s words."""
    spec = {"noise": (tuple(x_prev.shape[:-1]), "normal")}
    noise = draw_noise(key, spec, x_prev.shape[-1])["noise"]
    return ou_update(x_prev, noise, dt, mu, sigma)


def ou_reset(shape, device="cuda"):
    """The reference resets to zeros (x0=None path, Utils/Utils.py:23-24)."""
    return torch.zeros(shape, device=device)
