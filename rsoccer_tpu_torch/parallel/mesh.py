"""Process groups and batch-axis sharding over ``torch.distributed``.

Port of ``rsoccer_tpu/parallel/mesh.py``.  Scaling is pure data
parallelism over the env batch, as in the JAX package: a 1-D "mesh" whose
members are the ranks of one process group, one device each, with every
batched leaf sharded on its trailing batch axis.  Rank ``r`` of ``W`` owns
the global envs ``[r B / W, (r + 1) B / W)``.  The env step has no
cross-env data flow, so the rollout needs no collective; collectives
appear only where the JAX package's partitioned program has them: metric
sums and learner gradients.

The JAX mesh spans devices; this one spans processes.  A process group is
whatever the caller set up with :func:`initialize_distributed`: ``nccl``
with one rank per card, or ``gloo`` (CPU tensors, and several ranks
sharing one card).  Nothing here picks a backend.

Every collective but one is an ``all_reduce``, which both backends take
with CUDA tensors; gloo's ``all_gather`` takes CPU tensors only, so
:func:`gather_rows` gathers through an ``all_reduce`` of a zero-padded
stack instead (exact: each element has one non-zero term).  The one is
:func:`broadcast_params`, which both backends also take with CUDA tensors:
a learner's replicated networks start from the mesh's first rank's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

ENV_AXIS = "env"


class EnvMesh(NamedTuple):
    """This process's place in the env mesh."""

    rank: int
    world: int
    device: torch.device  # the device this rank's shard lives on
    group: object = None  # the process group (None: the default group)
    axis: str = ENV_AXIS


def initialize_distributed(backend: str, init_method: str, world_size: int, rank: int, **kwargs):
    """Multi-process bring-up: ``torch.distributed.init_process_group``
    passthrough.  The caller names the backend (``"nccl"``: one rank per
    card; ``"gloo"``: CPU tensors, or several ranks on one card) and the
    rendezvous (``"tcp://host:port"`` or ``"file:///path"``)."""
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kwargs)


def make_env_mesh(device="cuda", group=None) -> EnvMesh:
    """The mesh over ``group`` (default: the default process group), this
    rank's shard on ``device``.  Raises unless a process group is up: a
    one-rank mesh is a world of one, initialised like any other."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.mesh.initialize_distributed(backend, "
            "init_method, world_size, rank) first (world_size=1 for one rank)"
        )
    return EnvMesh(rank=dist.get_rank(group), world=dist.get_world_size(group),
                   device=torch.device(device), group=group)


def check_divisible(mesh: EnvMesh, **sizes):
    """Raise ``ValueError`` unless every size divides by the mesh size."""
    for name, val in sizes.items():
        if val % mesh.world:
            raise ValueError(f"{name}={val} not divisible by mesh size {mesh.world}")


def batch_slice(mesh: EnvMesh, n_global: int) -> slice:
    """This rank's range of a global batch of ``n_global``."""
    check_divisible(mesh, n_envs=n_global)
    n = n_global // mesh.world
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_batched_tree(tree, mesh: EnvMesh, batch_axis: int = -1):
    """This rank's shard of every tensor leaf of a global lane-layout tree
    (NamedTuples, tuples, lists and dicts), cut on ``batch_axis``,
    contiguous and on the mesh's device."""
    if isinstance(tree, torch.Tensor):
        sl = batch_slice(mesh, tree.shape[batch_axis])
        return tree.narrow(batch_axis, sl.start, sl.stop - sl.start).contiguous().to(mesh.device)
    if isinstance(tree, dict):
        return {k: shard_batched_tree(v, mesh, batch_axis) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_batched_tree(v, mesh, batch_axis) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batched_tree(v, mesh, batch_axis) for v in tree)
    return tree


def local_benv(benv, mesh: EnvMesh):
    """The rank's shard of the global batched env ``benv``: ``n_envs / W``
    envs on the mesh's device, the same path (fused, RNG mode,
    fused_physics), and ``env_base`` at the shard's first global env, so
    its draws are the unsharded batch's columns."""
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv

    sl = batch_slice(mesh, benv.n_envs)
    return BatchedEnv(benv.env, sl.stop - sl.start, device=mesh.device, fused=benv.fused,
                      fused_rng=benv.fused_rng, fused_physics=benv.fused_physics,
                      env_base=benv.env_base + sl.start)


def all_reduce_sum(t: torch.Tensor, mesh: EnvMesh) -> torch.Tensor:
    """In-place SUM over the mesh; returns ``t``.  Every rank ends with the
    same bits."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_reduce_mean(t: torch.Tensor, mesh: EnvMesh) -> torch.Tensor:
    """In-place mean over the mesh (SUM, then divide by W: ``lax.pmean``);
    returns ``t``."""
    return all_reduce_sum(t, mesh).div_(mesh.world)


def all_reduce_grads(params, mesh: EnvMesh, average: bool = False):
    """Sum (``average``: average) every parameter's gradient over the
    mesh, in one all_reduce of the flattened gradients."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    (all_reduce_mean if average else all_reduce_sum)(flat, mesh)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def broadcast_params(params, mesh: EnvMesh):
    """Overwrite every rank's ``params`` with the mesh's first rank's, bit
    for bit, in one broadcast of their flattened values: the replicas'
    common start, taken from one rank as DDP takes it, rather than trusted
    to each process drawing the same bits from the same seed."""
    params = list(params)
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    dist.broadcast(flat, src=src, group=mesh.group)
    off = 0
    with torch.no_grad():
        for p in params:
            p.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()


def gather_rows(t: torch.Tensor, mesh: EnvMesh) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order, ``(W, *t.shape)``: an
    all_reduce SUM of a stack that holds ``t`` in this rank's row and zeros
    elsewhere (gloo's ``all_gather`` refuses CUDA tensors; a sum with zeros
    is exact)."""
    out = torch.zeros((mesh.world, *t.shape), dtype=t.dtype, device=t.device)
    out[mesh.rank] = t
    return all_reduce_sum(out, mesh)
