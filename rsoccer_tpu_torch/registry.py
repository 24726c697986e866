"""Environment registry.

The reference's ids (rsoccer_gym/__init__.py:3-30), as far as the port has
carried them.  The other ids of the JAX package raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Callable, Dict

from rsoccer_tpu_torch.envs.ssl_contested_possession import SSLContestedPossessionEnv
from rsoccer_tpu_torch.envs.ssl_dribbling import SSLDribblingEnv
from rsoccer_tpu_torch.envs.ssl_pass_endurance import SSLPassEnduranceEnv
from rsoccer_tpu_torch.envs.ssl_static_defenders import SSLStaticDefendersEnv
from rsoccer_tpu_torch.envs.vss import VSSEnv

_REGISTRY: Dict[str, Callable] = {
    "VSS-v0": VSSEnv,
    "SSLStaticDefenders-v0": lambda **kw: SSLStaticDefendersEnv(**{"field_type": 2, **kw}),
    "SSLDribbling-v0": SSLDribblingEnv,
    "SSLContestedPossession-v0": SSLContestedPossessionEnv,
    "SSLPassEndurance-v0": SSLPassEnduranceEnv,
}

# ids of the JAX package still to port -> ROADMAP.md item
_NOT_PORTED = {
    "VSSMultiAgent-v0": "module queue item 12 (multi-agent and self-play)",
    "VSSSelfPlay-v0": "module queue item 12 (multi-agent and self-play)",
}


def not_ported(env_id: str) -> None:
    """Raise ``NotImplementedError`` for an id of the JAX package that the
    port has not carried yet, naming its ROADMAP item."""
    if env_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{env_id} is not ported to rsoccer_tpu_torch yet: "
            f"ROADMAP.md, {_NOT_PORTED[env_id]}"
        )


def make(env_id: str, **kwargs):
    """Create a functional env by reference id (e.g. ``"VSS-v0"``)."""
    not_ported(env_id)
    if env_id not in _REGISTRY:
        raise KeyError(
            f"Unknown env id {env_id!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[env_id](**kwargs)


def registered_ids():
    return sorted(_REGISTRY)
