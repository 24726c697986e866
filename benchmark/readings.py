"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--steps 12] [--control] [--out f.jsonl]

For each seed: one run of the cell's driver at the cell's own size with a
one-second window, ``--steps`` steps of the window checked (the traffic's
own count by default), and the numbers that decide ``correct`` (the lower
readings); with ``--control``, the same numbers with the reference computed
in bfloat16 standing in the program's place (the upper readings).  One JSON
line per seed, on standard output and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="", help="break the timed path underneath (the driver's FAULTS)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from benchmark import run as R

    R._environment()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = R.context(args.workload, seed, 1.0, False, dev,
                        controls=(torch.bfloat16,) if args.control else (), fault=args.fault or None)
        if args.steps:
            ctx.traffic["checked_steps"] = args.steps
        t0 = time.time()
        line, out = R.execute(ctx)
        rec = {"workload": args.workload, "seed": seed, "fault": args.fault, "correct": line["correct"], "failed": line["failed"],
               "checked_steps": ctx.traffic.get("checked_steps"), "readings": out["tally"].values,
               "worst": out["tally"].worst, "excused": out["tally"].excused,
               "check_s": out["record"]["check_s"], "seconds": time.time() - t0}
        for name, tally in out["controls"].items():
            rec[f"control.{name}"] = {"correct": tally.correct, "readings": tally.values,
                                      "excused": tally.excused}
        text = json.dumps(rec)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
