"""Train a SAC agent on any ported task on the card.

    python -m rsoccer_tpu_torch.examples.train_sac_vss [--envs 256] [--iters 2000]
    python -m rsoccer_tpu_torch.examples.train_sac_vss --env-id SSLStaticDefenders-v0 \
        --fused --envs 512 --iters 600000 --reward-scale 10 --n-step 8 --gamma 0.995 \
        --target-entropy-scale 0.5 --eval-every 50000 --eval-envs 256 \
        --save 'runs/sac_sd_{i}.ckpt'

Each iteration collects ``--env-steps-per-iter`` batched env steps into the
replay ring and runs ``--grad-steps`` SAC updates
(``rsoccer_tpu_torch/models/sac.py``).  Iteration ``i`` draws from a
generator seeded by ``(--seed + 1, i)``, so a ``--resume``d run draws what
an uninterrupted one would.  ``--fused`` steps through the env's fused
kernel with the env noise drawn inside it.  ``--save`` writes the actor as
the JAX package's ``actor_params`` checkpoint (``.npz``; a literal ``{i}``
keeps one per evaluation point), which ``--init`` and
``eval_policy --algo sac`` read.  With ``--log`` every logged iteration
appends one JSON line {iter, env_steps, wall_s, mean_reward, q_loss,
alpha}, and every evaluation one {iter, env_steps, wall_s, eval}.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

import rsoccer_tpu_torch as rt
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.eval import evaluate_policy
from rsoccer_tpu_torch.models.sac import SACConfig, SACTrainer, iteration_generator, make_policy
from rsoccer_tpu_torch.utils import checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    p.add_argument("--save", default="",
                   help="write the actor here at every evaluation and at the end; a literal '{i}' "
                   "is replaced by the iteration count")
    p.add_argument("--reward-scale", type=float, default=1.0)
    p.add_argument("--target-entropy-scale", type=float, default=1.0)
    p.add_argument("--n-step", type=int, default=1, help="n-step Q targets")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--bf16", action="store_true", help="bfloat16 towers (f32 params and heads)")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--grad-steps", type=int, default=2, help="gradient steps per iteration")
    p.add_argument("--env-steps-per-iter", type=int, default=1,
                   help="batched env steps collected per iteration")
    p.add_argument("--buffer-size", type=int, default=1 << 18,
                   help="replay capacity; scale it with --envs to keep capacity/envs iterations of history")
    p.add_argument("--init-alpha", type=float, default=0.1, help="initial temperature")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=50,
                   help="collect calls with uniform-random actions before the policy collects")
    p.add_argument("--env-kwargs", default="{}",
                   help="JSON kwargs for the TRAINING env (e.g. a curriculum); evaluation always "
                   "runs the default env")
    p.add_argument("--init", default="",
                   help="warm-start the ACTOR from an actor_params checkpoint (e.g. the BC clone "
                   "artifacts/sd_sac_bc.ckpt.npz); critics and temperature start fresh")
    p.add_argument("--actor-freeze", type=int, default=0,
                   help="hold the actor and temperature for the first N iterations (critics learn)")
    p.add_argument("--state-save", default="",
                   help="save the whole training state (replay ring included) at every evaluation")
    p.add_argument("--resume", action="store_true",
                   help="continue from --state-save if its meta file exists")
    p.add_argument("--fused", action="store_true",
                   help="step through the env's fused kernel, env noise drawn in the kernel")
    p.add_argument("--seed", type=int, default=0,
                   help="init from this seed; iteration i draws from (seed + 1, i)")
    p.add_argument("--log", default="", help="append JSONL curve points here")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--eval-every", type=int, default=0, help="deterministic eval every N iters (0: off)")
    p.add_argument("--eval-envs", type=int, default=128)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    benv = rt.make_vec(args.env_id, args.envs, device=args.device, fused=args.fused,
                       fused_rng="kernel", **json.loads(args.env_kwargs))
    cfg = SACConfig(
        buffer_size=args.buffer_size, batch_size=args.batch_size, warmup_steps=args.warmup,
        grad_steps_per_iter=args.grad_steps, env_steps_per_iter=args.env_steps_per_iter,
        init_alpha=args.init_alpha, lr=args.lr, reward_scale=args.reward_scale,
        target_entropy_scale=args.target_entropy_scale, n_step=args.n_step, gamma=args.gamma,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        actor_freeze_iters=args.actor_freeze,
    )
    trainer = SACTrainer(benv, cfg)
    state = trainer.init(args.seed)
    if args.init:
        actor = convert.load_sac_checkpoint(args.init, device=benv.device)
        if actor.hidden != cfg.hidden:
            raise SystemExit(f"--init has towers {actor.hidden}, SAC trains {cfg.hidden}")
        actor.compute_dtype = cfg.compute_dtype
        state = state._replace(actor=actor, opt_actor=trainer.make_optimizer(actor.parameters()))
        print(f"warm-started actor from {args.init}", flush=True)

    start = 0
    meta = args.state_save + ".meta.json"
    if args.resume and args.state_save and os.path.exists(meta):
        with open(meta) as fh:
            start = json.load(fh)["iter"] + 1
        state = trainer.state_from_tree(checkpoint.restore(args.state_save, like=trainer.state_tree(state)))
        print(f"resumed the whole SAC state from {args.state_save} @ iter {start}", flush=True)

    default_env = rt.make(args.env_id)
    eval_steps = default_env.max_episode_steps + default_env.max_episode_steps // 4
    log_f = open(args.log, "a") if args.log else None

    def emit(rec):
        if log_f:
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()

    spi = args.envs * cfg.env_steps_per_iter
    t0 = time.perf_counter()
    for i in range(start, args.iters):
        state, m = trainer.train_step(state, iteration_generator(args.seed, i, benv.device))
        last = i == args.iters - 1
        if (i + 1) % max(1, args.iters // 10) == 0 or last:
            print(f"iter {i:5d}  reward/step {float(m['mean_reward']):+.4f}  "
                  f"q_loss {float(m['q_loss']):.4f}  alpha {float(m['alpha']):.3f}", flush=True)
        if log_f and ((i + 1) % args.log_every == 0 or last):
            emit({"iter": i, "env_steps": (i + 1) * spi, "wall_s": round(time.perf_counter() - t0, 1),
                  **{k: float(m[k]) for k in ("mean_reward", "q_loss", "alpha")}})
        if args.eval_every and ((i + 1) % args.eval_every == 0 or last):
            # the default env: success is reported on the reference task
            # even when training runs with env kwargs
            out = evaluate_policy(args.env_id, make_policy(state.actor), n_envs=args.eval_envs,
                                  n_steps=eval_steps, seed=((args.seed + 2) << 32) | i,
                                  device=benv.device, fused=args.fused)
            rec = {"iter": i, "env_steps": (i + 1) * spi, "wall_s": round(time.perf_counter() - t0, 1),
                   "eval": out}
            print(f"eval @ iter {i}: {out}", flush=True)
            emit(rec)
            if args.save:
                checkpoint.save(args.save.replace("{i}", str(i + 1)), convert.sac_actor_to_numpy(state.actor))
            if args.state_save:
                checkpoint.save(args.state_save, trainer.state_tree(state))
                with open(meta, "w") as fh:
                    json.dump({"iter": i}, fh)
    steps = (args.iters - start) * spi
    print(f"{steps / 1e6:.2f}M env-steps in {time.perf_counter() - t0:.0f}s", flush=True)
    if args.save:
        final = args.save.replace("{i}", str(args.iters))
        checkpoint.save(final, convert.sac_actor_to_numpy(state.actor))
        print(f"saved the actor to {final}", flush=True)
    if log_f:
        log_f.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
