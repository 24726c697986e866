"""Pair-list robot-robot collision resolution.

Port of ``rsoccer_tpu/ops/pair_collide.py``.  The same contact physics as
``physics/common.resolve_robot_robot`` (equal-mass discs, de-penetration
split evenly, restitution impulse along the center line), over the
n(n-1)/2 upper-triangle pairs instead of the dense n x n matrix, applied
antisymmetrically (x_i += f, x_j -= f).  Its ``__device__`` twin,
``csrc/pair_collide.cuh``, is inlined in the fused SSL step kernels; the
fused VSS step evaluates the same terms per robot in partner order
(``csrc/vss_world.cuh``, held to this pass bit for bit by
``tests/test_torch_vss_pair_order.py``).  This plain version is what the
tests hold against the JAX resolver.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def resolve_pair_collisions(x, y, vx, vy, r_rbt: float, restitution: float):
    """One collision pass over all robot pairs.

    Args are (n, ...) rows (any trailing batch dims); returns the updated
    ``(x, y, vx, vy)``.  No-op for n <= 1.
    """
    n = x.shape[0]
    if n <= 1:
        return x, y, vx, vy
    pair_ij = [(i, j) for i in range(n) for j in range(i + 1, n)]
    ii = [i for i, _ in pair_ij]
    jj = [j for _, j in pair_ij]

    dx = x[ii] - x[jj]  # (P, ...)
    dy = y[ii] - y[jj]
    d2 = torch.clamp_min(dx * dx + dy * dy, _EPS * _EPS)
    inv_d = torch.rsqrt(d2)
    overlap = 2.0 * r_rbt - d2 * inv_d
    colliding = overlap > 0.0
    fx = torch.where(colliding, 0.5 * overlap, 0.0) * inv_d
    pnx = fx * dx
    pny = fx * dy
    rvx = vx[ii] - vx[jj]
    rvy = vy[ii] - vy[jj]
    vn = rvx * dx + rvy * dy  # (v_rel . n) * d
    g = torch.where(
        colliding & (vn < 0.0), -(1.0 + restitution) * 0.5 * vn, 0.0
    ) * (inv_d * inv_d)
    gx = g * dx
    gy = g * dy

    def scatter(base, rows):
        out = []
        for r in range(n):
            acc = base[r]
            for p, (i, j) in enumerate(pair_ij):
                if i == r:
                    acc = acc + rows[p]
                elif j == r:
                    acc = acc - rows[p]
            out.append(acc)
        return torch.stack(out)

    return scatter(x, pnx), scatter(y, pny), scatter(vx, gx), scatter(vy, gy)
