"""Train a PPO agent on VSS-v0 (or another ported task) on the card.

    python -m rsoccer_tpu_torch.examples.train_ppo_vss [--envs 2048] [--updates 50]
    python -m rsoccer_tpu_torch.examples.train_ppo_vss --fused --fused-rng kernel \
        --envs 8192 --save runs/vss_ppo.ckpt

Each update collects ``--rollout-steps`` x ``--envs`` transitions, runs GAE
and ``--num-epochs`` x ``--num-minibatches`` PPO steps
(``rsoccer_tpu_torch/models/ppo.py``).  ``--save`` writes the JAX
package's ``{params, obs_norm}`` checkpoint (``.npz``), which the JAX
package's ``utils/checkpoint.restore(path, like=...)`` and ``--init``
here both read.
"""

from __future__ import annotations

import argparse
import json
import time

import rsoccer_tpu_torch as rt
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer
from rsoccer_tpu_torch.utils import checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--envs", type=int, default=2048)
    p.add_argument("--updates", type=int, default=50)
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    p.add_argument("--save", default="",
                   help="write {params, obs_norm} here; a literal '{i}' is replaced by the update count")
    p.add_argument("--save-every", type=int, default=0, help="also write --save every K updates")
    p.add_argument("--init", default="", help="warm-start from a {params, obs_norm} checkpoint")
    p.add_argument("--freeze-obs-norm", action="store_true",
                   help="normalise with the --init checkpoint's stats without updating them")
    p.add_argument("--critic-warmup", type=int, default=0,
                   help="freeze the actor for the first N updates")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--anneal", action="store_true", help="linearly decay lr to 0 over --updates")
    p.add_argument("--anneal-updates", type=int, default=0,
                   help="the anneal schedule's length in updates, if not --updates")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--gae-lambda", type=float, default=0.95)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument("--minibatch-mode", default="shuffle", choices=["shuffle", "time"])
    p.add_argument("--hidden", default="256,256", help="comma-separated tower widths")
    p.add_argument("--num-epochs", type=int, default=4)
    p.add_argument("--num-minibatches", type=int, default=8)
    p.add_argument("--env-kwargs", default="{}",
                   help='JSON kwargs for the env ctor, e.g. \'{"curriculum": true}\'')
    p.add_argument("--fused", action="store_true",
                   help="step through the env's fused kernel (one launch per step)")
    p.add_argument("--fused-rng", default="input", choices=["input", "kernel"],
                   help="with --fused: 'kernel' draws the env noise inside the kernel")
    p.add_argument("--log-every", type=int, default=1, help="print metrics every K updates")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    benv = rt.make_vec(args.env_id, args.envs, device=args.device, fused=args.fused,
                       fused_rng=args.fused_rng, **json.loads(args.env_kwargs))
    cfg = PPOConfig(
        lr=args.lr,
        anneal_updates=(args.anneal_updates or args.updates) if args.anneal else 0,
        gamma=args.gamma,
        gae_lambda=args.gae_lambda,
        ent_coef=args.ent_coef,
        rollout_steps=args.rollout_steps,
        freeze_obs_norm=args.freeze_obs_norm,
        critic_warmup_updates=args.critic_warmup,
        minibatch_mode=args.minibatch_mode,
        hidden=tuple(int(h) for h in args.hidden.split(",")),
        num_epochs=args.num_epochs,
        num_minibatches=args.num_minibatches,
    )
    trainer = PPOTrainer(benv, cfg)
    state = trainer.init(0)
    if args.init:
        net, obs_norm = convert.load_ppo_checkpoint(args.init, device=benv.device)
        if net.hidden != cfg.hidden:
            raise SystemExit(f"--init has towers {net.hidden}, --hidden says {cfg.hidden}")
        state = state._replace(net=net, opt=trainer.make_optimizer(net), obs_norm=obs_norm)
        print(f"warm-started params+obs_norm from {args.init}", flush=True)

    def save(tag):
        path = args.save.replace("{i}", str(tag))
        checkpoint.save(path, convert.ppo_to_numpy(state.net, state.obs_norm))
        return path

    steps_per_update = cfg.rollout_steps * args.envs
    t_log = (time.perf_counter(), 0)
    for i in range(args.updates):
        state, metrics = trainer.train_step(state)
        if (i + 1) % args.log_every == 0 or i == args.updates - 1:
            ms = trainer.phase_ms()  # waits for this update
            now = time.perf_counter()
            rate = steps_per_update * (i + 1 - t_log[1]) / (now - t_log[0])
            t_log = (now, i + 1)
            print(
                f"update {i:5d}  reward/step {float(metrics['mean_reward']):+.4f}  "
                f"loss {float(metrics['loss']):+.4f}  entropy {float(metrics['entropy']):.4f}  "
                f"collect {ms['collect_ms']:.1f} ms  update {ms['update_ms']:.1f} ms  "
                f"env-steps/s {rate:,.0f}",
                flush=True,
            )
        if args.save and args.save_every and (i + 1) % args.save_every == 0:
            save(i + 1)
    if args.save:
        print(f"saved params+obs_norm to {save(args.updates)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
