"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``, which names its driver,
``drivers/<driver>.py``); its limits are ``limits/<cell>.json``.  The
driver sets up, warms up, measures for ``--seconds`` and checks what the
timed path produced against the reference.  With ``--trace 0`` the line
holds the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, each read by ``metrics/<metric>.py`` from a profiled sub-window.

Exits non-zero with no result where there is no CUDA card (or fewer than
the cell asks for), or where a module of ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``rsoccer_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "rsoccer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _environment():
    """Every build and kernel cache at a fixed path inside the checkout, and
    a launch queue four times the CUDA driver's default (1021 launches, ~33
    ms of a rollout step's work on an H100), so that the card runs on while
    the host stands still for up to ~130 ms.  Set before CUDA starts."""
    os.environ["CUDA_SCALE_LAUNCH_QUEUES"] = "4x"
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


@dataclasses.dataclass
class Context:
    """What a driver is given."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    limits: dict
    device: object
    fault: str | None = None  # a broken timed path (tests only)
    controls: tuple = ()  # dtypes in which the reference also stands in the program's place

    @staticmethod
    def since_start() -> float:
        from benchmark.harness.clock import since_start

        return since_start()


def context(workload: str, seed: int, seconds: float, trace: bool, device, **kw) -> Context:
    from benchmark.harness import manifest as M

    man = M.load_manifest()
    c = M.cell(man, workload)
    return Context(workload, seed, seconds, trace, M.load_json("configs", c["config"]),
                   M.load_json("traffic", c["traffic"]), M.load_json("limits", workload)["limits"],
                   device, **kw)


def execute(ctx: Context) -> dict:
    """Run the cell's driver and read its metrics: the result line's dict
    (without ``device``'s card fields) and the driver's output."""
    from benchmark.harness import manifest as M

    man = M.load_manifest()
    out = M.load_module("drivers", ctx.traffic["driver"]).run(ctx)
    metrics = {}
    for m in M.metrics_of(man, ctx.workload, ctx.trace):
        if ctx.trace:
            value = M.load_module("metrics", m["name"]).read(out["record"])
        else:
            value = out["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    tally = out["tally"]
    line = {"correct": tally.correct, "attempted": out["attempted"], "failed": tally.failed,
            "metrics": metrics}
    if ctx.trace and out["window"] is not None:
        line["breakdown"] = out["window"].breakdown()
    return line, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    import torch

    from benchmark.harness import manifest as M

    chips = M.cell(M.load_manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace), dev)
    line, out = execute(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    line["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
                      "memory_peak_bytes": out["memory_peak_bytes"]}
    if ctx.trace:
        busy_s, window_s = out["record"]["device_busy"]
        line["device"].update(busy_s=busy_s, window_s=window_s)
    line["checks"] = out["tally"].checks()
    for name, (env, value) in out["tally"].worst.items():
        print(f"worst {name}: {value} at env {env}", file=sys.stderr)
    if out["record"].get("pace"):
        print("window pace: " + ", ".join(f"{k} {v:.6g}" for k, v in out["record"]["pace"].items()),
              file=sys.stderr)
    print(f"the check took {out['record']['check_s']:.1f} s; envs the second look excused: "
          f"{out['tally'].excused}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
