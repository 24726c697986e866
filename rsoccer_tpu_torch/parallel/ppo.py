"""Helpers of the data-parallel PPO (``models/ppo.PPOTrainer(..., mesh=)``).

The JAX package has no ``parallel/ppo.py``: its sharded PPO is the
unsharded ``train_step`` under jit with the env batch sharded, and XLA's
partitioning inserts the collectives (``tools/distributed_smoke.py --impl
ppo``).  Here they are explicit, at the places that reduce over the global
batch:

- the minibatches come from the GLOBAL permutation, drawn alike on every
  rank; each rank keeps the members that fall in its env range
  (:func:`minibatch_members`), so in ``"shuffle"`` mode the local counts
  are uneven;
- the advantage normalisation and the obs normaliser need the global
  moments: each rank's ``(count, mean, var)`` are gathered and merged in
  rank order (Chan et al.'s pairwise update, :func:`merge_mean_var`), so
  every rank computes the same bits;
- the gradients are summed over the ranks between ``backward`` and the
  global-norm clip (``mesh.all_reduce_grads``).

A merge of one rank is the identity, so at ``W = 1`` every step gives the
unsharded trainer's bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rsoccer_tpu_torch.parallel.mesh import EnvMesh, gather_rows


class MinibatchShard(NamedTuple):
    """What a rank's part of one minibatch needs beyond its rows."""

    n_local: int  # the rank's members
    n_global: int  # the minibatch's members over all ranks
    adv_mean: torch.Tensor  # the minibatch's global advantage mean
    adv_std: torch.Tensor  # and its global population std
    world: int

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's part of the global mean of ``x`` over the minibatch:
        its local mean times its share (summed over the ranks, the global
        mean; at one rank exactly ``x.mean()``); 0 with no members."""
        if not self.n_local:
            return x.sum()
        return torch.mean(x) * (self.n_local / self.n_global)


def minibatch_members(perms, n_mb: int, n_rows: int, n_global: int, mesh: EnvMesh):
    """This rank's members of every ``"shuffle"`` minibatch.

    ``perms``: the epochs' permutations of the ``T x n_global`` flat sample
    indices ``t * n_global + b``, the same on every rank.  Minibatch ``k``
    of epoch ``e`` is ``perms[e][k * mb:(k + 1) * mb]``, ``mb = n_rows //
    n_mb``.  Returns ``(local, counts)``: ``local[e, k]`` holds the rank's
    members as flat indices ``t * B_local + (b - first)`` into its own
    ``(T, B_local)`` samples, in permutation order, first ``counts[e][k][rank]``
    entries; ``counts[e][k]`` is every rank's member count (one host sync
    for the whole update)."""
    b_local = n_global // mesh.world
    mb = n_rows // n_mb
    p = torch.stack([perm[: n_mb * mb] for perm in perms]).view(len(perms), n_mb, mb)
    t, b = p // n_global, p % n_global
    owner = b // b_local
    counts = torch.zeros((len(perms) * n_mb, mesh.world), dtype=torch.int64, device=p.device)
    counts.scatter_add_(1, owner.view(-1, mb), torch.ones_like(owner.view(-1, mb)))
    counts = counts.view(len(perms), n_mb, mesh.world).tolist()
    local = t * b_local + (b - mesh.rank * b_local)
    # the rank's members first, in permutation order (a stable sort)
    order = torch.sort((owner != mesh.rank).to(torch.uint8), dim=-1, stable=True).indices
    return local.gather(-1, order), counts


def merge_mean_var(counts, means, variances):
    """Chan et al.'s pairwise merge of per-rank ``(count, mean, var)``
    (population variances), in rank order, skipping empty ranks:
    ``(count, mean, var)`` of the union.  A merge of one is the identity."""
    n, mean, var = 0, None, None
    for c, m, v in zip(counts, means, variances):
        if not c:
            continue
        if not n:
            n, mean, var = c, m, v
            continue
        tot = n + c
        delta = m - mean
        mean = mean + delta * (c / tot)
        var = (var * n + v * c + delta**2 * (n * c / tot)) / tot
        n = tot
    return n, mean, var


def global_mean_std(x: torch.Tensor, counts, mesh: EnvMesh):
    """The mean and population std of the union of every rank's ``x``
    (``counts``: every rank's ``len(x)``).  Where one rank holds all of it,
    that rank's own ``x.mean()`` and ``x.std(correction=0)``, bit for bit
    (a std is not always the square root of the variance, to the bit)."""
    if x.numel():
        local = torch.stack([x.mean(), x.var(correction=0), x.std(correction=0)])
    else:
        local = torch.zeros((3,), dtype=x.dtype, device=x.device)
    rows = gather_rows(local, mesh)
    holders = [r for r, c in enumerate(counts) if c]
    if len(holders) == 1:
        return rows[holders[0], 0], rows[holders[0], 2]
    _, mean, var = merge_mean_var(counts, rows[:, 0], rows[:, 1])
    return mean, torch.sqrt(var)

