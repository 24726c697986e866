"""The numbers that decide ``correct``, each held to its limit.

Outputs are compared env by env.  For a group of leaves (the state, the
obs, ...) an env's error is the largest absolute gap over its float leaves,
each gap over the leaf's largest magnitude in the block (at least 1):
positions, velocities and angles are O(1), wheel speeds and rewards larger;
that is the group's ``<group>_err``.  Its integer and boolean leaves count
the envs where the two sides differ: ``<group>_mismatch``.  A NaN on either
side is an infinite error.
"""

from __future__ import annotations

import math

import torch


def flatten(tree, prefix: str = "") -> dict:
    """A tree of NamedTuples and tensors -> {"a.b.c": tensor}."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(flatten(getattr(tree, f), f"{prefix}{f}."))
        return out
    return {prefix[:-1]: tree}


def rebuild(tree, types: dict, fn):
    """The same tree with the NamedTuple classes of ``types`` (by class
    name) and ``fn`` applied to each tensor."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = types[type(tree).__name__]
        return cls(*(rebuild(getattr(tree, f), types, fn) for f in cls._fields))
    return fn(tree)


def _per_env(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).amax(0) if x.dim() > 1 else x


def env_errors(group: str, got: dict, want: dict) -> dict:
    """{"<group>_err": (B,) float64, "<group>_mismatch": (B,) 0/1} over the
    leaves of ``want`` (only the kinds the group has)."""
    err, mis = None, None
    for path, w in want.items():
        g = got[path]
        if w.is_floating_point():
            scale = max(1.0, float(torch.nan_to_num(w.abs().double(), nan=0.0).max()))
            e = _per_env(torch.nan_to_num((g.double() - w.double()).abs() / scale, nan=math.inf))
            err = e if err is None else torch.maximum(err, e)
        else:
            m = _per_env((g != w).to(torch.int32))
            mis = m if mis is None else torch.maximum(mis, m)
    out = {}
    if err is not None:
        out[f"{group}_err"] = err
    if mis is not None:
        out[f"{group}_mismatch"] = mis
    return out


def over(errors: dict, limits: dict) -> torch.Tensor:
    """The envs whose errors break a limit: (B,) bool."""
    bad = None
    for name, e in errors.items():
        b = e > limits[name]
        bad = b if bad is None else bad | b
    return bad


class Tally:
    """Largest errors and mismatch counts by number, and the env-steps that
    broke a limit."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values = {}
        self.failed = 0
        self.worst = {}  # number -> [env, value] of its largest reading
        self.base = 0  # the global index of the first env of the block being added
        self.excused = 0  # envs that a second look found within their limits (reported, not limited)

    def add(self, errors: dict):
        """Per-env errors of one block (``env_errors``' keys)."""
        for name, e in errors.items():
            if name.endswith("_mismatch"):
                self.values[name] = self.values.get(name, 0) + int(e.sum())
                continue
            top = float(e.max())
            if top > self.values.get(name, -1.0):
                self.worst[name] = [self.base + int(e.argmax()), top]
                self.values[name] = top
        self.failed += int(over(errors, self.limits).sum())

    def count(self, name: str, n: int):
        """Add ``n`` events to a number that counts them."""
        self.values[name] = self.values.get(name, 0) + n

    def checks(self) -> dict:
        """{name: {"value", "limit"}} for every limit, in the limits' order."""
        return {k: {"value": self.values.get(k), "limit": lim} for k, lim in self.limits.items()}

    @property
    def correct(self) -> bool:
        return all(k in self.values and self.values[k] <= lim for k, lim in self.limits.items())
