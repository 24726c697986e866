"""Spawn placement via fixed-shape masked rejection sampling.

Port of ``rsoccer_tpu/envs/spawn.py`` on batch-last tensors: each entity
draws ``N_CANDIDATES`` uniform candidates and takes the first one at least
``min_dist`` from every entity placed before it, else candidate 0 (the
reference's sequential rejection loop, vss_gym.py:214-231, with a fixed
budget).  :func:`sample_separated` and :func:`uniform_angles` are the
keyed conveniences: they draw from the port's Philox key
(``ops/philox.make_key``), so their numbers are not ``jax.random``'s.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.envs.base import draw_noise

# P(no valid candidate) <= 0.16^8 per point at reference densities
N_CANDIDATES = 8


def pick_first(ok, *arrays):
    """Each array's value at the first True of ``ok`` along axis 0, or at
    index 0 where ``ok`` has none (a one-hot masked sum, as the JAX
    package's).  ``ok`` and the arrays are ``(K, B)``; returns ``(B,)``s."""
    first = ok & (torch.cumsum(ok.to(torch.int32), dim=0) == 1)
    any_ok = ok.any(dim=0)
    sel = first.to(arrays[0].dtype)
    return tuple(torch.where(any_ok, (a * sel).sum(0), a[0]) for a in arrays)


def place_separated(u, x_lo: float, x_hi: float, y_lo: float, y_hi: float,
                    min_dist: float, preplaced_x=(), preplaced_y=()):
    """Place points sequentially in a box, each at least ``min_dist`` from
    the preplaced points (floats or ``(B,)`` tensors) and from every point
    placed before it.

    ``u``: ``(n_points, 2, N_CANDIDATES, B)`` uniforms in [0, 1).
    Returns ``(xs, ys)``, each ``(n_points, B)``.
    """
    px, py = list(preplaced_x), list(preplaced_y)
    n_pre = len(px)
    for i in range(u.shape[0]):
        cx = x_lo + u[i, 0] * (x_hi - x_lo)  # (K, B)
        cy = y_lo + u[i, 1] * (y_hi - y_lo)
        ok = torch.ones_like(cx, dtype=torch.bool)
        for qx, qy in zip(px, py):
            ddx = cx - qx
            ddy = cy - qy
            ok = ok & ((ddx * ddx + ddy * ddy) >= min_dist * min_dist)
        x_i, y_i = pick_first(ok, cx, cy)
        px.append(x_i)
        py.append(y_i)
    return torch.stack(px[n_pre:]), torch.stack(py[n_pre:])


def angles_from_uniform(u):
    """Uniform [0, 1) samples -> headings in radians."""
    return u * (2.0 * math.pi)


def sample_separated(key, n_points: int, x_lo: float, x_hi: float, y_lo: float, y_hi: float,
                     min_dist: float, preplaced_x=(), preplaced_y=(), batch: int = 1):
    """:func:`place_separated` with its uniforms drawn at ``key``'s step,
    which advances; returns ``(xs, ys)``, each ``(n_points, batch)``."""
    spec = {"u": ((n_points, 2, N_CANDIDATES), "uniform")}
    u = draw_noise(key, spec, batch)["u"]
    return place_separated(u, x_lo, x_hi, y_lo, y_hi, min_dist, preplaced_x, preplaced_y)


def uniform_angles(key, n: int, batch: int = 1):
    """``(n, batch)`` headings in [0, 2 pi) drawn at ``key``'s step, which
    advances."""
    return angles_from_uniform(draw_noise(key, {"u": ((n,), "uniform")}, batch)["u"])
