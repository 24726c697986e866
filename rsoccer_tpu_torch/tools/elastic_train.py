"""Elastic training: crash and resume, bit for bit.

The counterpart of the JAX package's ``tools/elastic_train.py``.  The
whole training state (networks, Adam, the env state, obs, the obs
normaliser, the key, the generators' states and, for SAC, the replay
ring) is one tree (``PPOTrainer.state_tree`` / ``SACTrainer.state_tree``):
snapshot it every ``--every`` updates with ``utils/checkpoint.save``, and
on restart restore it and go on.  Every draw of an update comes from that
state (PPO: its generators and key) or from the update's index (SAC:
``iteration_generator(seed, i)``), so a crashed and resumed run ends in
the same state as an uninterrupted one, bit for bit.

    python -m rsoccer_tpu_torch.tools.elastic_train --updates 12 --ckpt /tmp/ck --every 4
    python -m rsoccer_tpu_torch.tools.elastic_train --updates 12 --ckpt /tmp/ck --crash-at 6
    python -m rsoccer_tpu_torch.tools.elastic_train --updates 12 --ckpt /tmp/ck --resume

(``--device cpu`` off the card; ``--fused`` for the fused kernel path.)
Prints one JSON line: ``{"update", "digest", "mean_reward"}``; the digest
is a sha256 over every leaf of the state tree, in the tree's leaf order.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np
import torch


def state_digest(tree) -> str:
    """Order-stable hash over every leaf of a state tree."""
    from rsoccer_tpu_torch.utils.checkpoint import flatten

    h = hashlib.sha256()
    for leaf in flatten(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()[:16]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--envs", type=int, default=32)
    p.add_argument("--updates", type=int, default=12)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--every", type=int, default=4)
    p.add_argument("--crash-at", type=int, default=0,
                   help="simulate failure: exit(1) before this update runs")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--algo", default="ppo", choices=["ppo", "sac"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--fused", action="store_true", help="the fused kernel path, kernel RNG")
    return p.parse_args(argv)


def make_trainer(args):
    import rsoccer_tpu_torch as rt

    benv = rt.make_vec(args.env_id, args.envs, device=args.device, fused=args.fused,
                       fused_rng="kernel" if args.fused else "input")
    if args.algo == "sac":
        from rsoccer_tpu_torch.models.sac import SACConfig, SACTrainer

        return SACTrainer(benv, SACConfig(buffer_size=1 << 10, batch_size=32, warmup_steps=2, n_step=3))
    from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer

    return PPOTrainer(benv, PPOConfig(rollout_steps=8, num_epochs=1, num_minibatches=2))


def main(argv=None) -> dict:
    """Run (or resume) the training; returns the printed record.  A
    simulated crash exits the process with code 1 (``SystemExit``)."""
    from rsoccer_tpu_torch.utils import checkpoint

    args = parse_args(argv)
    trainer = make_trainer(args)
    state = trainer.init(args.seed)
    start = 0
    if args.resume:
        with open(args.ckpt + ".meta.json") as f:
            start = json.load(f)["update"]
        state = trainer.state_from_tree(checkpoint.restore(args.ckpt, like=trainer.state_tree(state)))

    if args.algo == "sac":
        from rsoccer_tpu_torch.models.sac import iteration_generator

        def step(state, i):
            return trainer.train_step(state, iteration_generator(args.seed, i, trainer.device))
    else:
        def step(state, i):
            return trainer.train_step(state)

    metrics = None
    for i in range(start, args.updates):
        if args.crash_at and i == args.crash_at:
            print(f"simulated crash before update {i}", file=sys.stderr, flush=True)
            sys.exit(1)
        state, metrics = step(state, i)
        done = i + 1
        if done % args.every == 0 or done == args.updates:
            checkpoint.save(args.ckpt, trainer.state_tree(state))
            with open(args.ckpt + ".meta.json", "w") as f:
                json.dump({"update": done}, f)
    out = {
        "update": args.updates,
        "digest": state_digest(trainer.state_tree(state)),
        "mean_reward": None if metrics is None else float(metrics["mean_reward"]),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
