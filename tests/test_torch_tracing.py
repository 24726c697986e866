"""The port's spans, counter table and set-up phases (``utils/tracing``).

The CPU tests run the fused path's plain versions; the one ``cuda`` test
holds the spans to the card's kernels by correlation id.  This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_tracing.py -m cuda
"""

import collections
import time
import timeit

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import rsoccer_tpu_torch
from rsoccer_tpu_torch.batch import rollout as R
from rsoccer_tpu_torch.ops import _build
from rsoccer_tpu_torch.ops import vss_full as vf
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.utils import tracing

B = 8
STEPS = 3
SPANS = (tracing.ROLLOUT_STEP, tracing.POLICY, tracing.ENV_STEP, tracing.ENV_KERNEL)
SETUP = (tracing.SETUP_MAKE_VEC, tracing.SETUP_RESET)


def rollout(env_id, fused_rng="kernel", device="cpu", n_envs=B, seed=0):
    benv = rsoccer_tpu_torch.make_vec(env_id, n_envs, device=device, fused=True, fused_rng=fused_rng)
    return R.make_rollout_fn(benv, STEPS), R.init_carry(benv, seed)


def host_spans(prof) -> dict:
    """``{span name: [(start_ns, end_ns)]}`` of the ``rsoccer.*`` host
    events in ``prof``."""
    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith("rsoccer."):
            out[e.name()].append((e.start_ns(), e.end_ns()))
    return out


def inside(inner, outer) -> bool:
    return any(a <= inner[0] and inner[1] <= b for a, b in outer)


def test_spans_stay_off_outside_a_profiler(monkeypatch):
    """With no profiler running a span touches no profiler code: a 3-step
    fused rollout runs with both the span's recorder and
    ``record_function`` made to raise."""

    def refuse(*a, **k):
        raise AssertionError("a span reached the profiler")

    monkeypatch.setattr(tracing, "_record", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    roll, carry = rollout("VSS-v0")
    carry, ms = roll(carry)
    assert bool(torch.isfinite(carry.obs).all()) and float(ms.episodes) >= 0


@pytest.mark.parametrize("fused_rng", ["kernel", "input"])
@pytest.mark.parametrize("env_id", ["VSS-v0", "SSLStaticDefenders-v0"])
def test_rollout_spans_nest(env_id, fused_rng):
    """N steps under a CPU profiler give exactly N of each span: the policy
    and the env step inside a rollout step, the kernel inside the env step."""
    roll, carry = rollout(env_id, fused_rng)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        roll(carry)
    spans = host_spans(prof)
    assert {k: len(v) for k, v in spans.items()} == dict.fromkeys(SPANS, STEPS)
    for name, parent in ((tracing.POLICY, tracing.ROLLOUT_STEP), (tracing.ENV_STEP, tracing.ROLLOUT_STEP),
                         (tracing.ENV_KERNEL, tracing.ENV_STEP)):
        assert all(inside(s, spans[parent]) for s in spans[name]), name
    assert not any(inside(s, spans[tracing.POLICY]) for s in spans[tracing.ENV_STEP])


def test_span_start_is_on_the_epoch_clock():
    """A span's kineto start lies between ``time.time_ns()`` read before and
    after it: the host spans share the device trace's clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        with tracing.span("rsoccer.test.clock"):
            torch.ones(4).sum()
        t1 = time.time_ns()
    (start, end), = host_spans(prof)["rsoccer.test.clock"]
    assert t0 <= start <= end <= t1


@pytest.mark.parametrize("env_id", ["VSS-v0", "SSLStaticDefenders-v0"])
def test_rollout_bit_identical_under_the_profiler(env_id):
    """The spans change nothing the rollout computes."""
    outs = []
    for traced in (False, True):
        roll, carry = rollout(env_id, seed=4)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                outs.append(roll(carry))
        else:
            outs.append(roll(carry))
    (c0, m0), (c1, m1) = outs
    for a, b in zip((c0.state, c0.obs, c0.key, c0.ep_return, c0.ep_length, *m0),
                    (c1.state, c1.obs, c1.key, c1.ep_return, c1.ep_length, *m1)):
        assert torch.equal(a, b)


def test_make_vec_and_reset_add_their_phases():
    before = tracing.snapshot()
    t0 = time.time_ns()
    benv = rsoccer_tpu_torch.make_vec("VSS-v0", B, device="cpu", fused=True)
    benv.reset(make_key(1, device="cpu"))
    t1 = time.time_ns()
    now, then = tracing.phases(), tracing.phases(before)
    for name in SETUP:
        assert now[name]["count"] == then.get(name, {}).get("count", 0) + 1, name
        assert 0 < now[name]["seconds"] - then.get(name, {}).get("seconds", 0.0) <= (t1 - t0) * 1e-9, name
        assert now[name]["first_start_ns"] <= t1, name


def test_phase_opens_its_span_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        benv = rsoccer_tpu_torch.make_vec("VSS-v0", B, device="cpu")
        benv.reset(make_key(2, device="cpu"))
    assert {k: len(v) for k, v in host_spans(prof).items()} == dict.fromkeys(SETUP, 1)


@pytest.mark.parametrize("seconds", [0.0, 2.5], ids=["warm", "cold"])
def test_library_phase_counts_builds(monkeypatch, seconds):
    """``rsoccer.setup.library``: one phase per load, a build counted only
    where nvcc ran, and nvcc's seconds."""
    monkeypatch.setattr(tracing, "counters", collections.Counter())
    monkeypatch.setattr(_build, "build", lambda: ("lib.so", "", seconds))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_declare", lambda lib: lib)
    assert _build.load.__wrapped__() == "lib.so"
    got = tracing.phases()[tracing.SETUP_LIBRARY]
    assert got["count"] == 1 and got["builds"] == (seconds > 0) and got["build_s"] == seconds
    assert got["seconds"] >= 0 and got["first_start_ns"] > 0


def test_launch_table(monkeypatch):
    """Launches by wrapper, C entry and variant; the wrapper's total is the
    sum of its entries; counts since a snapshot; clearing keeps phases."""
    monkeypatch.setattr(tracing, "counters", collections.Counter())
    for entry, final, n in (("a", False, 3), ("a", True, 2), ("b", False, 1)):
        for _ in range(n):
            tracing.launched("w", entry, final)
    tracing.launched("other", "a", False)
    assert tracing.launches("w") == 6 and tracing.launches(vf.vss_full_step) == 0
    assert tracing.launches("w", entry="a") == 5 and tracing.launches("w", final=True) == 2
    assert tracing.launches("w", entry="b", final=True) == 0
    assert tracing.entry_launches("w") == {"a": 5, "b": 1}
    snap = tracing.snapshot()
    tracing.launched("w", "b", True)
    assert tracing.launches("w", since=snap) == 1 and tracing.entry_launches("w", since=snap) == {"b": 1}
    with tracing.phase("rsoccer.test.phase"):
        pass
    tracing.clear_launches()
    assert tracing.launches("w") == 0 and tracing.entry_launches("w") == {}
    assert tracing.phases()["rsoccer.test.phase"]["count"] == 1


def test_span_costs_little_when_off():
    """Off, a span is a flag check and a shared null context: well under a
    microsecond on a quiet host (the generous limit allows a loaded one),
    where an ungated ``record_function`` costs ~13 µs."""
    def off():
        with tracing.span(tracing.ROLLOUT_STEP):
            pass

    n = 20000
    us = min(timeit.repeat(off, number=n, repeat=7)) / n * 1e6
    assert us < 3.0, us


@pytest.mark.cuda
def test_env_kernel_span_on_the_card():
    """On the card: each K1 launch is attributed to a ``rsoccer.env.kernel``
    span by its launch's correlation id; a profile of CUDA activity alone
    records no ``rsoccer.*`` host event; the library's phase is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    roll, carry = rollout("VSS-v0", device="cuda", n_envs=256)
    carry, _ = roll(carry)  # builds and loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        carry, _ = roll(carry)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launch_at = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() == DeviceType.CPU and "LaunchKernel" in e.name()}
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA and "vss_" in e.name()
               and not e.is_user_annotation()]
    spans = host_spans(prof)[tracing.ENV_KERNEL]
    assert len(kernels) == STEPS and len(spans) == STEPS
    for k in kernels:
        t = launch_at[k.correlation_id()]
        assert any(a <= t < b for a, b in spans), k.name()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        roll(carry)
        torch.cuda.synchronize()
    assert not host_spans(prof)
    lib = tracing.phases()[tracing.SETUP_LIBRARY]
    assert lib["count"] == 1 and lib["builds"] in (0, 1)
