"""Profile SAC iterations (collect + replay + gradient steps).

The counterpart of the JAX package's ``tools/profile_sac.py``:

    python -m rsoccer_tpu_torch.tools.profile_sac [--envs 512] [--chain 200] \\
        [--env-id SSLStaticDefenders-v0] [--n-step 8] [--bf16] [--fused --fused-rng kernel]

Two warm-up calls, then ``--iters`` timed calls of ``--chain`` iterations
each (a Python loop of ``SACTrainer.train_step``, iteration ``i`` drawing
from ``iteration_generator(0, i)``), between CUDA events on the card and
on the host clock on the CPU: prints µs per iteration and env-steps/s;
then one call under ``torch.profiler`` (``tools/_trace.py``): the top 40
kernels by device time with their launches, the busy share, the Chrome
trace under ``--out``.  ``--bf16`` sets ``SACConfig.compute_dtype`` to
``torch.bfloat16``; ``--fused``/``--fused-rng`` are the JAX tool's
``--pallas-full``/``--pallas-rng``.
"""

from __future__ import annotations

import argparse
import json

import torch

TOP = 40


def sac_config(args):
    """The JAX tool's recipe: warmup 50 collects, the ring's default size."""
    from rsoccer_tpu_torch.models.sac import SACConfig

    return SACConfig(
        batch_size=args.batch_size, warmup_steps=50, grad_steps_per_iter=args.grad_steps,
        env_steps_per_iter=args.env_steps_per_iter, reward_scale=args.reward_scale,
        n_step=args.n_step, gamma=args.gamma,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )


def main(argv=None) -> dict:
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.models.sac import SACTrainer, iteration_generator
    from rsoccer_tpu_torch.tools import _trace

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--envs", type=int, default=512)
    p.add_argument("--env-id", default="SSLStaticDefenders-v0")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--grad-steps", type=int, default=2)
    p.add_argument("--env-steps-per-iter", type=int, default=1)
    p.add_argument("--n-step", type=int, default=8)
    p.add_argument("--gamma", type=float, default=0.995)
    p.add_argument("--reward-scale", type=float, default=10.0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fused", action="store_true", help="the fused step kernel")
    p.add_argument("--fused-rng", default="input", choices=["input", "kernel"])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--chain", type=int, default=200, help="iterations per timed and profiled call")
    p.add_argument("--out", default="chiprun_out/profile_sac")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    benv = rt.make_vec(args.env_id, args.envs, device=device, fused=args.fused, fused_rng=args.fused_rng)
    trainer = SACTrainer(benv, sac_config(args))
    box = [trainer.init(0)]

    def call():
        for _ in range(args.chain):
            box[0], _ = trainer.train_step(box[0], iteration_generator(0, box[0].iteration, device))

    for _ in range(2):
        call()
    trainer.phase_ms()  # waits for the last iteration
    secs = _trace.time_calls(call, args.iters, device)
    dt = secs / (args.iters * args.chain)
    steps_per = args.envs * args.env_steps_per_iter
    timer = "cuda_events" if device.type == "cuda" else "host_clock"
    print(f"{dt * 1e6:.0f} us/iter, {steps_per / dt / 1e6:.2f}M env-steps/s ({args.envs} envs x "
          f"{args.env_steps_per_iter} step(s), {args.grad_steps} grad steps @ batch {args.batch_size}, "
          f"n_step {args.n_step}, chain {args.chain}, {timer})")
    trace = _trace.profile(call, 1, args.out, device, name="profile_sac", match=_trace.ENV_KERNELS,
                           expect=args.env_steps_per_iter * args.chain if args.fused else 0)
    print(f"trace: {trace.path}")
    print(trace.table(TOP))
    print(f"busy share {trace.busy_share:.3f} of the profiled window ({trace.events} events, "
          f"{trace.timer})")
    out = {"env_id": args.env_id, "n_envs": args.envs, "chain": args.chain, "card": _trace.card_line(device),
           "timer": timer, "us_per_iter": dt * 1e6, "env_steps_per_s": steps_per / dt,
           "trace": trace.summary(TOP)}
    print(json.dumps({k: v for k, v in out.items() if k != "trace"}))
    return out


if __name__ == "__main__":
    main()
