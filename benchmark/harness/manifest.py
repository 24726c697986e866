"""``BENCHMARK.json`` and the files it names, found by name.

- ``configs/<config>.json``: the configuration's sizes and env arguments;
- ``traffic/<traffic>.json``: the traffic mix's parameters and its driver;
- ``limits/<cell>.json``: the limits of the cell's compared numbers;
- ``drivers/<driver>.py``: the code that runs a traffic mix;
- ``metrics/<metric>.py``: one reader per per-layer metric.

A later cell, configuration or metric is new files and new entries, never
an edit of a file here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` key only in the cells it lists."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]
