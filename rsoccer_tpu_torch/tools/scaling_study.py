"""Batch-size scaling study: env-steps/s against the number of parallel envs.

The counterpart of the JAX package's ``tools/scaling_study.py``:

    python -m rsoccer_tpu_torch.tools.scaling_study [--env-id VSS-v0] \\
        [--sizes 2048,8192,32768,131072] [--fused]

For each batch size: two warm-up rollouts of ``--steps`` steps
(``batch/rollout.make_rollout_fn``, uniform random policy), then
``--iters`` timed ones between two CUDA events on the card's stream (the
host clock on the CPU); prints one JSON line per size with env-steps/s and
µs per batched step, beside the card's name.  The JAX tool's ``--rng-impl``
(the TPU's key implementation) has no counterpart: the port has one
Philox stream (``ops/philox.py``), drawn in the kernel with ``--fused``.
"""

from __future__ import annotations

import argparse
import json

import torch

from rsoccer_tpu_torch.tools._trace import time_calls


def time_rollouts(roll, carry, iters: int, device: torch.device):
    """Seconds for ``iters`` calls of ``roll`` after the carry; CUDA events
    on the card, the host clock on the CPU.  Returns (seconds, carry)."""
    box = [carry]

    def call():
        box[0], _ = roll(box[0])

    return time_calls(call, iters, device), box[0]


def main(argv=None) -> list:
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--sizes", default="2048,8192,32768,131072")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fused", action="store_true", help="the fused kernel path, kernel RNG")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rows = []
    for b in (int(s) for s in args.sizes.split(",")):
        benv = rt.make_vec(args.env_id, b, device=device, fused=args.fused,
                           fused_rng="kernel" if args.fused else "input")
        roll = R.make_rollout_fn(benv, args.steps)
        carry = R.init_carry(benv, seed=0)
        for _ in range(2):
            carry, ms = roll(carry)
        float(ms.total_reward)
        secs, carry = time_rollouts(roll, carry, args.iters, device)
        n_steps = args.steps * args.iters
        row = {"env_id": args.env_id, "B": b, "fused": args.fused, "device": name,
               "timer": "cuda_events" if device.type == "cuda" else "host_clock",
               "env_steps_per_s": n_steps * b / secs, "us_per_step": secs / n_steps * 1e6}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
