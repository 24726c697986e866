"""State carried across between the JAX package and the port.

``state_from_numpy`` takes one of the JAX package's batched env states
(``VSSState``, ``SDState``, ``CPState``) with numpy leaves
(``jax.tree.map(np.asarray, s)``) — or any object with the same attribute
tree — and builds the port's state of the class it is given on ``device``
(the card unless the caller asks for the CPU).  ``state_to_numpy`` goes
back: the port's state with numpy leaves, whose fields flatten in the JAX
package's leaf order.  The same pair exists for noise dicts.  The ported
slices have no model weights to carry.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from rsoccer_tpu_torch.core.state import tree_map


def _is_namedtuple_type(t) -> bool:
    return isinstance(t, type) and issubclass(t, tuple) and hasattr(t, "_fields")


def _from(obj, cls, device):
    hints = typing.get_type_hints(cls)
    fields = []
    for name in cls._fields:
        sub = getattr(obj, name)
        if _is_namedtuple_type(hints.get(name)):
            fields.append(_from(sub, hints[name], device))
        else:
            fields.append(torch.tensor(np.asarray(sub), device=device))
    return cls(*fields)


def state_from_numpy(tree, cls, device="cuda"):
    """JAX-package env state (numpy leaves) -> the port's ``cls``
    (``VSSState``, ``SDState`` or ``CPState``)."""
    return _from(tree, cls, device)


def state_to_numpy(state):
    """Port env state -> the same NamedTuple with numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)


def noise_from_numpy(noise: dict, device="cuda") -> dict:
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in noise.items()}


def noise_to_numpy(noise: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in noise.items()}
