"""Multi-process distributed smoke: the port's multi-rank launch recipe.

The counterpart of the JAX package's ``tools/distributed_smoke.py``.  Runs
one rank of a sharded rollout, PPO or SAC over ``torch.distributed`` and
prints, on rank 0, one JSON line with the JAX tool's keys (``num_processes``
and ``global_devices`` are both the world size: a rank is a device here).
The same command runs on every rank with its own ``--rank``:

    # rank r of 2 on the CPU (gloo), rendezvous through a file
    python -m rsoccer_tpu_torch.tools.distributed_smoke --impl jit \\
        --world-size 2 --rank r --init-method file:///tmp/rdv \\
        --backend gloo --device cpu

    # one rank per card (nccl); torchrun sets RANK and WORLD_SIZE
    torchrun --nproc-per-node 4 -m rsoccer_tpu_torch.tools.distributed_smoke \\
        --impl ppo --backend nccl --init-method env://

``--impl``: ``jit`` the sharded rollout (``parallel/rollout.
make_sharded_rollout``: the shards together are the unsharded rollout);
``shard_map`` the per-shard rollout (keys folded with the rank); ``ppo``
two sharded PPO train steps (``PPOTrainer(..., mesh=)``); ``sac`` ten
sharded SAC iterations (``parallel/sac.make_sharded_sac``: a ring per
rank, averaged gradients, replicated networks).  ``--device cuda`` with
``--backend nccl`` puts rank r on card ``r % device_count``; ranks that
share a card take ``gloo``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--impl", choices=["jit", "shard_map", "ppo", "sac"], default="jit")
    p.add_argument("--world-size", type=int, default=int(os.environ.get("WORLD_SIZE", 1)))
    p.add_argument("--rank", type=int, default=int(os.environ.get("RANK", 0)))
    p.add_argument("--init-method", required=True,
                   help="rendezvous: file:///path, tcp://host:port or env://")
    p.add_argument("--backend", required=True, choices=["nccl", "gloo"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--envs", type=int, default=64, help="global envs")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--towers", choices=["bf16", "f32"], default="bf16",
                   help="ppo: the towers' compute dtype (bf16, the JAX tool's; f32 keeps W ranks "
                   "within rel 1e-4 of one, where bf16 rounding magnifies the sums' order)")
    p.add_argument("--minibatch-mode", choices=["shuffle", "time"], default="shuffle")
    return p.parse_args(argv)


def param_digest(modules) -> str:
    """sha256 over every parameter's bytes, in order."""
    h = hashlib.sha256()
    for m in modules:
        for prm in m.parameters():
            h.update(prm.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def param_checksum(modules) -> float:
    """The sum of |param| over every parameter (the JAX tool's checksum)."""
    return float(sum(float(prm.detach().abs().sum()) for m in modules for prm in m.parameters()))


def run(args) -> dict:
    """One rank's run; returns the JSON record (every rank computes it)."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.parallel import mesh as M

    device = torch.device(args.device)
    if device.type == "cuda" and args.backend == "nccl":
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    M.initialize_distributed(args.backend, args.init_method, args.world_size, args.rank)
    try:
        mesh = M.make_env_mesh(device)
        benv = rt.make_vec("VSS-v0", args.envs, device=device)
        out = {"impl": args.impl, "num_processes": mesh.world, "global_devices": mesh.world}
        out.update(_IMPLS[args.impl](args, benv, mesh))
        return out
    finally:
        torch.distributed.destroy_process_group()


def global_abs_sum(t, mesh) -> float:
    """The sum of |t| over every rank's shard (f64)."""
    from rsoccer_tpu_torch.parallel.mesh import all_reduce_sum

    return float(all_reduce_sum(t.abs().sum().to(torch.float64), mesh))


def params_equal_across_ranks(modules, mesh) -> bool:
    """Whether every rank holds the same parameters, bit for bit."""
    from rsoccer_tpu_torch.parallel.mesh import gather_rows

    mine = torch.tensor(int(param_digest(modules), 16) & 0x7FFF_FFFF_FFFF_FFFF, device=mesh.device)
    rows = gather_rows(mine, mesh)
    return bool((rows == rows[0]).all())


def _rollout(args, benv, mesh) -> dict:
    from rsoccer_tpu_torch.batch.rollout import init_carry
    from rsoccer_tpu_torch.parallel.rollout import (
        make_shard_map_rollout, make_sharded_rollout, shard_carry,
    )

    if args.impl == "jit":
        roll, init = make_sharded_rollout(benv, mesh, args.steps)
        carry = init(args.seed)
    else:
        roll = make_shard_map_rollout(benv, mesh, args.steps)
        carry = shard_carry(init_carry(benv, args.seed), mesh)
    carry, ms = roll(carry)
    return {
        "total_reward": float(ms.total_reward),
        "episodes": int(ms.episodes),
        "episode_length_sum": float(ms.episode_length_sum),
        "obs_sum": global_abs_sum(carry.obs, mesh),
    }


def _ppo(args, benv, mesh) -> dict:
    from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer

    cfg = PPOConfig(rollout_steps=8, num_epochs=2, num_minibatches=2, minibatch_mode=args.minibatch_mode)
    trainer = PPOTrainer(benv, cfg, mesh=mesh)
    state = trainer.init(args.seed)
    state.net.compute_dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[args.towers]
    for _ in range(2):
        state, metrics = trainer.train_step(state)
    return {
        "loss": float(metrics["loss"]),
        "mean_reward": float(metrics["mean_reward"]),
        "param_checksum": param_checksum([state.net]),
        "param_digest": param_digest([state.net]),
        "params_equal_across_ranks": params_equal_across_ranks([state.net], mesh),
        "obs_sum": global_abs_sum(state.obs, mesh),
    }


def _sac(args, benv, mesh) -> dict:
    from rsoccer_tpu_torch.models.sac import SACConfig
    from rsoccer_tpu_torch.parallel.sac import make_sharded_sac

    cfg = SACConfig(buffer_size=args.envs * 16, batch_size=64, warmup_steps=2, n_step=3)
    local, init, step = make_sharded_sac(benv, cfg, mesh)
    state = init(args.seed)
    for i in range(10):
        state, metrics = step(state, args.seed, i)
    nets = [state.actor, state.qs, state.qs_target]
    return {
        "q_loss": float(metrics["q_loss"]),
        "mean_reward": float(metrics["mean_reward"]),
        "alpha": float(metrics["alpha"]),
        "param_checksum": param_checksum([state.actor]),
        "param_digest": param_digest(nets),
        "params_equal_across_ranks": params_equal_across_ranks(nets, mesh),
        "obs_sum": global_abs_sum(state.obs, mesh),
        "filled_local": state.buffer.filled,
    }


_IMPLS = {"jit": _rollout, "shard_map": _rollout, "ppo": _ppo, "sac": _sac}


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    if args.rank == 0:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
