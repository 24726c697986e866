"""``correct`` on the CPU at a size a test run holds: a sound run of each
cell's driver passes; the control (the reference computed in bfloat16 in
the program's place) and each fault planted under the timed path fail."""

import pytest
import torch

from benchmark import run as R
from benchmark.harness import manifest as M

CELLS = [w["name"] for w in M.load_manifest()["workloads"]]


def _ctx(cell, seed, **kw):
    ctx = R.context(cell, seed, 1.0, False, torch.device("cpu"), **kw)
    ctx.traffic.update(n_envs=48, steps_per_call=3, check_block=32)
    return ctx


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(cell):
    line, out = R.execute(_ctx(cell, 2**31 + 11, controls=(torch.bfloat16,)))
    assert line["correct"] and line["failed"] == 0, out["tally"].checks()
    assert out["tally"].values["near_ties"] == 0
    control = out["controls"]["torch.bfloat16"]
    assert not control.correct
    assert control.values["near_ties"] > 0


FAULTS = [(c, f) for c in CELLS
          for f in M.load_module("drivers", M.load_json("traffic", M.cell(M.load_manifest(), c)["traffic"])
                                 ["driver"]).FAULTS]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault):
    line, out = R.execute(_ctx(cell, 2**31 + 12, fault=fault))
    assert not line["correct"], out["tally"].checks()
