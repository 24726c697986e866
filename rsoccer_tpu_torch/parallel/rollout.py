"""Sharded rollouts over an env mesh.

Port of ``rsoccer_tpu/parallel/rollout.py``.  Each rank steps its own
shard of the env batch (``parallel/mesh.local_benv``) with the batched
rollout of ``batch/rollout.py``, zero collectives in the hot loop, and
the metric sums reduce once at the end of the call.

:func:`make_sharded_rollout` is the counterpart of the JAX package's
jit-partitioned rollout: the shards together run the UNSHARDED program,
env for env.  Each shard's env noise comes from the global env indices
(``env_base``), and the uniform policy draws the global ``(A, B)`` block
on every rank and keeps its own columns, which is what XLA's partitioning
gives the JAX variant.  :func:`make_shard_map_rollout` is the explicit
per-shard variant: the keys are folded with the rank, so shards draw
independent streams (numerically different from the unsharded run, the
same distribution), and the key stream comes back replicated.
"""

from __future__ import annotations

import hashlib
from typing import Callable

import torch

from rsoccer_tpu_torch.batch.rollout import (
    RolloutCarry,
    RolloutMetrics,
    init_carry,
    make_rollout_fn,
)
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.ops.philox import fold_in
from rsoccer_tpu_torch.parallel.mesh import (
    EnvMesh,
    all_reduce_sum,
    batch_slice,
    local_benv,
    shard_batched_tree,
)


def shard_carry(carry: RolloutCarry, mesh: EnvMesh) -> RolloutCarry:
    """This rank's shard of a global rollout carry: batched leaves cut on
    the batch axis, the env key and the policy generator replicated (each
    rank gets its own copy)."""
    gen = torch.Generator(device=mesh.device)
    gen.set_state(carry.pol_gen.get_state())
    return RolloutCarry(
        state=shard_batched_tree(carry.state, mesh),
        obs=shard_batched_tree(carry.obs, mesh),
        key=carry.key.clone().to(mesh.device),
        pol_gen=gen,
        ep_return=shard_batched_tree(carry.ep_return, mesh),
        ep_length=shard_batched_tree(carry.ep_length, mesh),
    )


def reduce_metrics(ms: RolloutMetrics, mesh: EnvMesh) -> RolloutMetrics:
    """The four sums summed over the mesh: one all_reduce (f64, so the
    integer episode count and the f32 sums travel exactly)."""
    flat = all_reduce_sum(torch.stack([m.to(torch.float64) for m in ms]), mesh)
    return RolloutMetrics(*(f.to(m.dtype) for f, m in zip(flat, ms)))


def sharded_uniform_policy(action_size: int, n_global: int, cols: slice) -> Callable:
    """The uniform random policy of the unsharded batch, sharded: draws the
    global ``(A, n_global)`` block from the replicated generator and keeps
    the columns ``cols``."""
    def sharded(gen, obs):
        u = torch.rand((action_size, n_global), generator=gen, device=obs.device)
        return u[:, cols] * 2.0 - 1.0

    return sharded


def make_sharded_rollout(benv: BatchedEnv, mesh: EnvMesh, n_steps: int, policy=None):
    """Build ``(rollout, init)`` for this rank's shard of the global batch
    ``benv``.  ``init(seed)`` is ``batch/rollout.init_carry``'s carry for
    the shard (its envs reset as the unsharded batch's columns);
    ``rollout(carry) -> (carry, metrics)`` steps the shard and returns the
    GLOBAL metric sums.  With the default uniform policy the shards
    together equal the unsharded rollout env for env; a given ``policy``
    sees the shard's obs.  ``benv.n_envs`` must be divisible by the mesh
    size."""
    cols = batch_slice(mesh, benv.n_envs)
    lbenv = local_benv(benv, mesh)
    if policy is None:
        policy = sharded_uniform_policy(benv.action_size, benv.n_envs, cols)
    local = make_rollout_fn(lbenv, n_steps, policy=policy)

    def rollout(carry: RolloutCarry):
        carry, ms = local(carry)
        return carry, reduce_metrics(ms, mesh)

    def init(seed: int) -> RolloutCarry:
        return init_carry(lbenv, seed)

    return rollout, init


def fold_generator(gen: torch.Generator, rank: int) -> torch.Generator:
    """A generator for rank ``rank``'s own stream, seeded from ``gen``'s
    state (read on the host, no device sync) and the rank."""
    digest = hashlib.sha256(gen.get_state().numpy().tobytes() + rank.to_bytes(4, "little")).digest()
    return torch.Generator(device=gen.device).manual_seed(int.from_bytes(digest[:8], "little"))


def make_shard_map_rollout(benv: BatchedEnv, mesh: EnvMesh, n_steps: int, policy=None):
    """Explicit per-shard rollout: each rank steps its ``n_envs / W`` envs
    as a batch of its own (env_base 0) with the env key and the policy
    stream folded with its rank, so shards draw independent noise; the
    metrics are summed over the mesh at the end.  The carry's key comes
    back replicated (rank 0's folded stream, advanced by the steps, on
    every rank) and its policy generator advanced alike on every rank.

    ``rollout(carry) -> (carry, metrics)``; the carry is a shard of a
    replicated-key carry (:func:`shard_carry`)."""
    batch_slice(mesh, benv.n_envs)  # the divisibility check
    lbenv = BatchedEnv(benv.env, benv.n_envs // mesh.world, device=mesh.device, fused=benv.fused,
                       fused_rng=benv.fused_rng, fused_physics=benv.fused_physics)
    local = make_rollout_fn(lbenv, n_steps, policy=policy)

    def rollout(carry: RolloutCarry):
        key = fold_in(carry.key, mesh.rank)
        gen = fold_generator(carry.pol_gen, mesh.rank)
        out, ms = local(carry._replace(key=key, pol_gen=gen))
        # a replicated key stream for the next call: rank 0's folded key,
        # as far as this call advanced it, computed alike on every rank
        key_out = fold_in(carry.key, 0)
        key_out[2] = out.key[2]
        # advance the replicated policy stream alike on every rank
        torch.empty((1,), device=mesh.device).random_(generator=carry.pol_gen)
        return out._replace(key=key_out, pol_gen=carry.pol_gen), reduce_metrics(ms, mesh)

    return rollout
