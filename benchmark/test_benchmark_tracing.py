"""The reader of the program's set-up phases, and the accepted readers
with the program's spans beside the harness's."""

import collections
import sys

import pytest

from benchmark.harness import manifest as M
from benchmark.harness import trace

PROGRAM_SPANS = ("rsoccer.rollout.step", "rsoccer.policy", "rsoccer.env.step", "rsoccer.env.kernel")


def _window(program_spans: bool):
    """A window of 100 steps, 88.6 ms of device time in ``bench.env_step``;
    with ``program_spans`` the program's spans beside it, as a harness
    that gathers them would hold them."""
    count, device_s, launches = {"bench.env_step": 100}, {"bench.env_step": 0.0886}, {"bench.env_step": 100}
    if program_spans:
        for name, s, n in zip(PROGRAM_SPANS, (0.0971, 0.0016, 0.0893, 0.0886), (2300, 300, 500, 200)):
            count[name], device_s[name], launches[name] = 100, s, n
    return trace.Window(kernels={}, span_count=count, span_device_s=device_s, span_launches=launches,
                        gaps=[["outside spans / rsoccer.rollout.step", 0.002]] if program_spans else [])


@pytest.mark.parametrize("name", ["env_step_device_us", "env_step_roofline", "device_idle_share.rollout"])
def test_accepted_readers_ignore_program_spans(name):
    read = M.load_module("metrics", name).read
    cfg = M.load_json("configs", "vss-3v3")
    rec = {"config": cfg, "n_envs": 1048576, "profiled_steps": 100, "profiled_resets": 300000.0,
           "device_busy": (0.95, 1.0)}
    without = read({**rec, "window": _window(False)})
    assert without is not None
    assert read({**rec, "window": _window(True)}) == without


def test_setup_program_s_sums_the_setup_phases():
    total = M.load_module("metrics", "setup_program_s").total
    table = collections.Counter({
        ("phase", "rsoccer.setup.library", "seconds"): 0.25,
        ("phase", "rsoccer.setup.library", "build_s"): 60.0,  # inside the library's seconds
        ("phase", "rsoccer.setup.library", "count"): 1,
        ("phase", "rsoccer.setup.make_vec", "seconds"): 0.5,
        ("phase", "rsoccer.setup.reset", "seconds"): 1.25,
        ("phase", "rsoccer.setup.reset", "first_start_ns"): 1_700_000_000_000_000_000,
        ("phase", "rsoccer.other", "seconds"): 9.0,
        ("launch", "vss_full_step", "vss_full_step", False): 7,
    })
    assert total(table) == pytest.approx(2.0)
    assert total({("launch", "w", "e", False): 1}) is None and total({}) is None


def test_setup_program_s_in_the_run(monkeypatch):
    """In-process the reader reads the program's table; where the program
    keeps none (a tree without it) it reads nothing and raises nothing."""
    import rsoccer_tpu_torch
    import rsoccer_tpu_torch.utils

    read = M.load_module("metrics", "setup_program_s").read
    rsoccer_tpu_torch.make_vec("VSS-v0", 4, device="cpu")
    assert read({}) > 0
    monkeypatch.delattr(rsoccer_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "rsoccer_tpu_torch.utils.tracing", None)  # the import raises
    assert read({}) is None
