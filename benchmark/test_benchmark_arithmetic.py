"""The roofline and idle-share arithmetic against numbers worked out by hand."""

import pytest

from benchmark.harness import manifest as M
from benchmark.harness import peaks, trace


def _window(device_s, spans, launches=1):
    return trace.Window(kernels={}, span_count={"bench.env_step": spans},
                        span_device_s={"bench.env_step": device_s},
                        span_launches={"bench.env_step": launches}, gaps=[])


def test_vss_env_step_least_time():
    cfg = M.load_json("configs", "vss-3v3")
    # 2 x 63 state rows + 2 actions + 40 obs + 9 out rows = 177 f32 = 708 B per env
    n = 1048576
    by_bytes = 708 * n / 3.35e12  # 221.59 us
    by_ops = (4357 * n + 2056 * 3000) / 67e12  # 68.28 us
    assert peaks.env_step_least_s(cfg, n, 3000) == pytest.approx(by_bytes, rel=1e-12)
    assert by_bytes == pytest.approx(221.59e-6, rel=1e-4) and by_ops < by_bytes


def test_sd_env_step_least_time():
    cfg = M.load_json("configs", "ssl-sd")
    # 2 x 57 + 5 + 24 + 11 = 154 f32 = 616 B per env
    assert peaks.env_step_least_s(cfg, 2097152, 0) == pytest.approx(616 * 2097152 / 3.35e12, rel=1e-12)


def test_env_step_roofline_reader():
    read = M.load_module("metrics", "env_step_roofline").read
    cfg = M.load_json("configs", "vss-3v3")
    rec = {"config": cfg, "n_envs": 1048576, "window": _window(0.0886, 100), "profiled_steps": 100,
           "profiled_resets": 300000.0}
    # 221.59 us least over 886 us per step
    assert read(rec) == pytest.approx(100 * 708 * 1048576 / 3.35e12 / 886e-6, rel=1e-9)
    us = M.load_module("metrics", "env_step_device_us").read(rec)
    assert us == pytest.approx(886.0)


def test_reader_finds_nothing_returns_nothing():
    rec = {"config": {}, "n_envs": 1, "window": None, "device_busy": None}
    for name in ("env_step_roofline", "env_step_device_us", "device_idle_share.rollout"):
        assert M.load_module("metrics", name).read(rec) is None
    assert M.load_module("metrics", "env_step_device_us").read(
        {"window": _window(0.0, 0, launches=0)}) is None


def test_idle_share_reader():
    # 0.9 s of kernels in a 1.0 s span of device activity: 10% idle
    read = M.load_module("metrics", "device_idle_share.rollout").read
    assert read({"device_busy": (0.9, 1.0)}) == pytest.approx(10.0)
    assert read({"device_busy": (1.0, 1.0)}) == 0.0


def test_union_of_intervals():
    assert trace._union([(5, 7), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 7]]
