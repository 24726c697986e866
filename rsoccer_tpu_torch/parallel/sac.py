"""Sharded SAC: the off-policy learner over an env mesh.

Port of ``rsoccer_tpu/parallel/sac.py``.  The replay ring stays out of the
collectives entirely:

- **a ring per rank**: each rank owns a private ring of ``buffer_size / W``
  slots fed by its own ``n_envs / W`` envs (``parallel/mesh.local_benv``:
  their noise is the global batch's columns), and samples its own
  ``batch_size / W`` minibatch from it; the insert stride (the local env
  count) and the strided n-step chains stay rank-local;
- **replicated networks**: they start as the first rank's draws
  (``parallel/mesh.broadcast_params``); each rank computes its gradients
  on its local minibatch, and each of the three is averaged over the ranks
  before its optimiser steps (``models/sac.SACTrainer(..., mesh=)``), so
  the applied update is the gradient of the global minibatch's mean loss
  and the networks stay bit-identical on every rank.  The iteration's draws come
  from the iteration's generator folded with the rank
  (``models/sac.iteration_generator(..., rank=)``).

The ring's counts (``buffer.ptr``, ``buffer.filled``) and
``total_steps`` are per rank and alike on every rank: ``filled`` counts
LOCAL slots, the global transition count is ``filled * W``.
"""

from __future__ import annotations

import torch

from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.models.sac import SACConfig, SACState, SACTrainer, iteration_generator
from rsoccer_tpu_torch.parallel.mesh import EnvMesh, all_reduce_mean, check_divisible, local_benv


def make_sharded_sac(benv: BatchedEnv, cfg: SACConfig, mesh: EnvMesh):
    """Build this rank's half of the data-parallel SAC over the global
    batched env ``benv``.  Returns ``(local_trainer, init, step)``:

    - ``local_trainer``: the rank's ``SACTrainer`` (``n_envs / W`` envs, a
      ring of ``buffer_size / W``, minibatch ``batch_size / W``, gradients
      averaged over the mesh); use it for ``make_policy`` and checkpoints;
    - ``init(seed) -> SACState``: the rank's state (networks from ``seed``,
      the first rank's broadcast to every rank; its envs reset as the
      global batch's columns);
    - ``step(state, seed, iteration) -> (state, metrics)``: one SAC
      iteration with the draws of ``iteration_generator(seed, iteration)``
      folded with the rank; the metrics are averaged over the mesh.

    Raises ``ValueError`` unless ``n_envs``, ``buffer_size`` and
    ``batch_size`` divide by the mesh size."""
    check_divisible(mesh, n_envs=benv.n_envs, buffer_size=cfg.buffer_size, batch_size=cfg.batch_size)
    local_cfg = cfg._replace(buffer_size=cfg.buffer_size // mesh.world,
                             batch_size=cfg.batch_size // mesh.world)
    local_trainer = SACTrainer(local_benv(benv, mesh), local_cfg, mesh=mesh)

    def init(seed: int) -> SACState:
        return local_trainer.init(seed)

    def step(state: SACState, seed: int, iteration: int):
        gen = iteration_generator(seed, iteration, mesh.device, rank=mesh.rank)
        state, metrics = local_trainer.train_step(state, gen)
        keys = sorted(metrics)
        means = all_reduce_mean(torch.stack([metrics[k] for k in keys]), mesh)
        return state, dict(zip(keys, means))

    return local_trainer, init, step
