"""Environment registry.

The reference's ids (rsoccer_gym/__init__.py:3-30) and the JAX package's
two extensions (``VSSMultiAgent-v0``, ``VSSSelfPlay-v0``).
"""

from __future__ import annotations

from typing import Callable, Dict

from rsoccer_tpu_torch.envs.ssl_contested_possession import SSLContestedPossessionEnv
from rsoccer_tpu_torch.envs.ssl_dribbling import SSLDribblingEnv
from rsoccer_tpu_torch.envs.ssl_pass_endurance import SSLPassEnduranceEnv
from rsoccer_tpu_torch.envs.ssl_static_defenders import SSLStaticDefendersEnv
from rsoccer_tpu_torch.envs.vss import VSSEnv
from rsoccer_tpu_torch.envs.vss_multiagent import VSSMultiAgentEnv
from rsoccer_tpu_torch.envs.vss_selfplay import VSSSelfPlayEnv

_REGISTRY: Dict[str, Callable] = {
    "VSS-v0": VSSEnv,
    "SSLStaticDefenders-v0": lambda **kw: SSLStaticDefendersEnv(**{"field_type": 2, **kw}),
    "SSLDribbling-v0": SSLDribblingEnv,
    "SSLContestedPossession-v0": SSLContestedPossessionEnv,
    "SSLPassEndurance-v0": SSLPassEnduranceEnv,
    # extensions of the JAX package (not part of the reference surface)
    "VSSMultiAgent-v0": VSSMultiAgentEnv,
    "VSSSelfPlay-v0": VSSSelfPlayEnv,
}


def register(env_id: str, factory: Callable):
    """Register ``factory(**kwargs) -> env`` under ``env_id`` (replacing
    any factory already there), for :func:`make`."""
    _REGISTRY[env_id] = factory


def make(env_id: str, **kwargs):
    """Create a functional env by reference id (e.g. ``"VSS-v0"``)."""
    if env_id not in _REGISTRY:
        raise KeyError(
            f"Unknown env id {env_id!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[env_id](**kwargs)


def registered_ids():
    return sorted(_REGISTRY)
