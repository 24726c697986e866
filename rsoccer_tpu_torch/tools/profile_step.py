"""Profile the batched env step: the top kernels of one rollout.

The counterpart of the JAX package's ``tools/profile_step.py``:

    python -m rsoccer_tpu_torch.tools.profile_step [--env-id VSS-v0] \\
        [--envs 8192] [--steps 100] [--mode full-krng]

Two warm-up rollouts of ``make_rollout_fn(benv, --steps)`` (uniform
random policy), then one under ``torch.profiler`` (``tools/_trace.py``):
prints the Chrome trace's path (under ``--out``), the top 30 kernels by
device time with their launches, and the card's busy share of the
profiled window.  ``--mode`` takes the JAX tool's ``--pallas`` values:
``0`` the plain path, ``1`` the VSS physics kernel, ``full`` the fused
step with input rows, ``full-krng`` the fused step drawing its noise
(``tools/bench_all.py``).  On the CPU (``--device cpu``) the numbers are
the CPU ops' self time on the host clock.
"""

from __future__ import annotations

import argparse
import json

import torch

TOP = 30


def main(argv=None) -> dict:
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.tools import _trace
    from rsoccer_tpu_torch.tools.bench_all import MODES, make_benv

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--envs", type=int, default=8192)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--out", default="chiprun_out/profile_step")
    p.add_argument("--mode", default="0", choices=MODES,
                   help="0: plain path, 1: VSS physics kernel, full: fused step kernel, "
                   "full-krng: fused step kernel drawing its noise")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    benv = make_benv(args.env_id, args.envs, args.mode, device)
    roll = R.make_rollout_fn(benv, args.steps)
    box = [R.init_carry(benv, seed=0)]

    def call():
        box[0], ms = roll(box[0])
        return ms

    for _ in range(2):
        ms = call()
    float(ms.total_reward)
    # on a kernel path the env kernel launches once per step
    trace = _trace.profile(call, 1, args.out, device, name="profile_step", match=_trace.ENV_KERNELS,
                           expect=args.steps if args.mode != "0" else 0)
    print(f"trace: {trace.path}")
    print(trace.table(TOP))
    print(f"busy share {trace.busy_share:.3f} of the profiled window ({trace.events} events, "
          f"{trace.timer})")
    out = {"env_id": args.env_id, "n_envs": args.envs, "steps": args.steps, "mode": args.mode,
           "card": _trace.card_line(device), **trace.summary(TOP)}
    print(json.dumps({k: v for k, v in out.items() if k not in ("top", "kernels")}))
    return out


if __name__ == "__main__":
    main()
