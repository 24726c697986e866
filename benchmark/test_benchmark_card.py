"""One short run of every cell on the card, through ``run.py``'s command
line: the last line is the result, ``correct`` is true, and the metrics
are the cell's."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import manifest as M

CELLS = [w["name"] for w in M.load_manifest()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 99),
                          "--seconds", "2", "--trace", str(trace)], cwd=M.ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    want = {m["name"] for m in M.metrics_of(M.load_manifest(), cell, bool(trace))}
    assert set(line["metrics"]) == want
