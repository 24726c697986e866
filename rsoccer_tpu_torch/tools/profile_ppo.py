"""Profile PPO train steps (collect + GAE + minibatched updates).

The counterpart of the JAX package's ``tools/profile_ppo.py``:

    python -m rsoccer_tpu_torch.tools.profile_ppo [--envs 4096] \\
        [--env-id SSLStaticDefenders-v0] [--fused --fused-rng kernel]

Two warm-up calls, then ``--iters`` timed calls of ``--chain`` train steps
each (a Python loop of ``PPOTrainer.train_step``; capturing it as one
graph is later work, ROADMAP.md), between CUDA events on the card and on
the host clock on the CPU: prints ms per update, env-steps/s and the last
update's ``PPOTrainer.phase_ms()``; then one call under
``torch.profiler`` (``tools/_trace.py``): the top 40 kernels by device
time with their launches, the busy share, the Chrome trace under
``--out``.  ``--fused``/``--fused-rng`` are the JAX tool's
``--pallas-full``/``--pallas-rng``; its ``--rollout-unroll`` (a
``lax.scan`` unroll) has no counterpart: the collect is a Python loop.
"""

from __future__ import annotations

import argparse
import json

import torch

TOP = 40


def main(argv=None) -> dict:
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer
    from rsoccer_tpu_torch.tools import _trace

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--env-id", default="SSLStaticDefenders-v0")
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument("--minibatch-mode", default="shuffle")
    p.add_argument("--fused", action="store_true", help="the fused step kernel")
    p.add_argument("--fused-rng", default="input", choices=["input", "kernel"])
    p.add_argument("--hidden", default="256,256")
    p.add_argument("--num-minibatches", type=int, default=8)
    p.add_argument("--num-epochs", type=int, default=4)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--chain", type=int, default=1, help="train steps per timed and profiled call")
    p.add_argument("--out", default="chiprun_out/profile_ppo")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    benv = rt.make_vec(args.env_id, args.envs, device=device, fused=args.fused, fused_rng=args.fused_rng)
    trainer = PPOTrainer(benv, PPOConfig(
        rollout_steps=args.rollout_steps, minibatch_mode=args.minibatch_mode,
        hidden=tuple(int(h) for h in args.hidden.split(",")),
        num_minibatches=args.num_minibatches, num_epochs=args.num_epochs,
    ))
    box = [trainer.init(0)]

    def call():
        for _ in range(args.chain):
            box[0], _ = trainer.train_step(box[0])

    for _ in range(2):
        call()
    trainer.phase_ms()  # waits for the last step
    secs = _trace.time_calls(call, args.iters, device)
    dt = secs / (args.iters * args.chain)
    steps_per = args.rollout_steps * args.envs
    timer = "cuda_events" if device.type == "cuda" else "host_clock"
    phase_ms = trainer.phase_ms()
    print(f"{dt * 1e3:.1f} ms/update, {steps_per / dt / 1e6:.2f}M env-steps/s ({args.envs} envs x "
          f"{args.rollout_steps} rollout steps, chain {args.chain}, {timer}); last update {phase_ms}")
    trace = _trace.profile(call, 1, args.out, device, name="profile_ppo", match=_trace.ENV_KERNELS,
                           expect=args.rollout_steps * args.chain if args.fused else 0)
    print(f"trace: {trace.path}")
    print(trace.table(TOP))
    print(f"busy share {trace.busy_share:.3f} of the profiled window ({trace.events} events, "
          f"{trace.timer})")
    out = {"env_id": args.env_id, "n_envs": args.envs, "chain": args.chain, "card": _trace.card_line(device),
           "timer": timer, "ms_per_update": dt * 1e3, "env_steps_per_s": steps_per / dt,
           "phase_ms": phase_ms, "trace": trace.summary(TOP)}
    print(json.dumps({k: v for k, v in out.items() if k != "trace"}))
    return out


if __name__ == "__main__":
    main()
