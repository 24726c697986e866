"""Ornstein-Uhlenbeck action noise as explicit state.

Port of ``rsoccer_tpu/envs/ou.py`` (reference Utils/Utils.py:5-29): the
process state lives in the env state and each step advances it from a
pre-drawn standard-normal block.
"""

from __future__ import annotations

import math

OU_THETA = 0.17  # reference Utils/Utils.py:6


def ou_update(x_prev, noise, dt: float, mu: float = 0.0, sigma: float = 0.5):
    """One Euler-Maruyama OU update from pre-drawn ``noise``; any shape."""
    return x_prev + OU_THETA * (mu - x_prev) * dt + sigma * math.sqrt(dt) * noise
