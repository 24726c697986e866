"""Profile a callable under ``torch.profiler``: time by kernel, launches,
busy share, matmul FLOPs, and a Chrome trace.

The counterpart of the JAX package's ``utils/profiling.trace`` and of the
trace-parsing loop its tools each carried (``tools/profile_step.py``,
``profile_ppo.py``, ``profile_sac.py``, ``roofline.py``); the port's
tools share this one.  :func:`profile` runs ``fn`` ``n`` times under
``torch.profiler.profile`` and writes the window as a Chrome trace
(``<out_dir>/<name>.trace.json.gz``; Perfetto and ``chrome://tracing``
open it), the counterpart of the JAX tools' ``--out`` trace directory.
:func:`rollout_loop` reads where a rollout's device time goes outside its
env kernel, by the port's spans.

On the card the window holds CPU and CUDA activities and the numbers are
the CUDA kernels' device time (``events == "cuda"``); a user annotation's
range on the device (``Optimizer.step#Adam.step``) spans kernels counted
on their own and is left out.  On the CPU the window holds CPU activities
only and the numbers are the CPU ops' self time on the host clock
(``events == "cpu"``, ``timer == "host_clock"``): never device time.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import re
import subprocess
import time

import torch

# the matmul-class ops, whose FLOPs torch.profiler counts (with_flops)
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
# the env kernels K1, K2 and K4-K7 by name
ENV_KERNELS = r"vss_(full|thread)_kernel|vss_physics_(thread_)?kernel|(sd|cp|dr|pe)_(full|thread)_kernel"
RETRIES = 3  # windows taken when one sees too few launches matching ``match``
# the runtime calls that enqueue device work (a device operation's launch)
LAUNCH = re.compile(r"launch|memcpy|memset", re.IGNORECASE)
RUNTIME = re.compile(r"^(cuda|cu)[A-Z]")


@dataclasses.dataclass
class Trace:
    """One profiled window."""

    events: str  # "cuda": device kernels; "cpu": CPU ops' self time
    timer: str  # "profiler" on the card, "host_clock" on the CPU
    kernels: dict  # name -> [us, count], by time, largest first
    busy_us: float  # the union of the events' intervals
    window_us: float  # the window on the host clock, synchronised at its end
    calls: int  # calls of fn in the window
    windows: int  # windows taken, the last one kept (RETRIES)
    calls_run: int  # every call of fn, the warm-up steps' and the dropped windows' too
    matmul_flops: int  # of the MATMUL_OPS (with_flops), else 0
    gemm_kernels: frozenset  # the kernels that MATMUL_OPS launched (on the card)
    path: str | None  # the Chrome trace

    @property
    def total_us(self) -> float:
        return sum(us for us, _ in self.kernels.values())

    @property
    def busy_share(self) -> float:
        return self.busy_us / self.window_us

    def top(self, n: int) -> list:
        """The ``n`` largest: [{"name", "us", "launches"}]."""
        return [{"name": k, "us": us, "launches": c} for k, (us, c) in list(self.kernels.items())[:n]]

    def table(self, n: int) -> str:
        """The ``n`` largest as lines of ms, launches and name."""
        return "\n".join(f"{us / 1e3:10.3f} ms {c:7d}x  {k[:110]}" for k, (us, c) in
                         list(self.kernels.items())[:n])

    def summary(self, n: int) -> dict:
        """What a tool returns: labels, totals, the ``n`` largest and every
        kernel's [us, launches]."""
        return {"events": self.events, "timer": self.timer, "calls": self.calls, "windows": self.windows,
                "calls_run": self.calls_run,
                "total_us": self.total_us, "busy_us": self.busy_us, "window_us": self.window_us,
                "busy_share": self.busy_share, "trace": self.path, "top": self.top(n),
                "kernels": self.kernels}


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[device.index or 0]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _launched_by(evt) -> list:
    """The device kernels that ``evt`` and the ops inside it launched."""
    names = [k.name for k in evt.kernels]
    for child in evt.cpu_children:
        names += _launched_by(child)
    return names


def profile(fn, n: int, out_dir: str | None, device, name: str = "trace", with_flops: bool = False,
            match: str = "", expect: int = 1) -> Trace:
    """Run ``fn`` ``n`` times under the profiler (``torch.cuda.synchronize``
    inside the window on the card) and read the window.  On the card the
    window follows one call of ``fn`` traced and dropped, and a window that
    saw fewer than ``expect`` launches of the kernels whose name the
    regular expression ``match`` finds is taken again, up to ``RETRIES``
    windows in all: the profiler there has been seen to drop a window's
    first launches, and a caller that knows how often a kernel launches
    (an env kernel once per env step) gets a whole window.  ``out_dir``:
    where the Chrome trace goes (None: no trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    device = torch.device(device)
    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    want = DeviceType.CUDA if on_card else DeviceType.CPU
    # on the card a warm-up step, one call of fn traced and dropped, then
    # the recorded window: the profiler there has been seen to drop the
    # first launches it traces
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    for windows in range(1, RETRIES + 1):
        with torch.profiler.profile(activities=acts, schedule=sched, record_shapes=with_flops,
                                    with_flops=with_flops) as prof:
            if on_card:
                fn()
                torch.cuda.synchronize(device)
            prof.step()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            if on_card:
                torch.cuda.synchronize(device)
            window_us = (time.perf_counter() - t0) * 1e6
            prof.step()
        evts = [e for e in prof.events() if e.device_type == want and not getattr(e, "is_user_annotation", False)]
        if not on_card or sum(bool(re.search(match, e.name)) for e in evts) >= expect:
            break
    kernels, spans = {}, []
    for e in evts:
        us = e.time_range.elapsed_us() if on_card else e.self_cpu_time_total
        row = kernels.setdefault(e.name, [0.0, 0])
        row[0] += us
        row[1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    matmuls = [e for e in prof.events() if e.device_type == DeviceType.CPU and e.name in MATMUL_OPS]
    gemm = frozenset(k for e in matmuls for k in _launched_by(e)) if on_card else frozenset()
    path = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{name}.trace.json.gz")
        prof.export_chrome_trace(path)
    return Trace(
        events="cuda" if on_card else "cpu",
        timer="profiler" if on_card else "host_clock",
        kernels=dict(sorted(kernels.items(), key=lambda kv: -kv[1][0])),
        busy_us=_union_us(spans),
        window_us=window_us,
        calls=n,
        windows=windows,
        calls_run=windows * (n + int(on_card)),
        matmul_flops=sum(int(e.flops or 0) for e in matmuls),
        gemm_kernels=gemm,
        path=path,
    )


def rollout_loop(call, n_calls: int) -> dict:
    """Where a rollout's device time goes outside its env kernel, by the
    port's spans (``utils/tracing``), on the card: ``n_calls`` calls of
    ``call`` (one ``make_rollout_fn`` call) profiled with the host's ops,
    after one call traced and dropped.  A device operation belongs to a
    span when the runtime call that launched it (its correlation id) lies
    within the span on the host's timeline.

    Per ``rsoccer.rollout.step``: ``launches`` (every device operation of
    the window, the env kernel's and those between the steps included),
    ``loop_device_us`` (the device time of those outside
    ``rsoccer.env.kernel``), ``kernel_device_us`` (inside it), and
    ``in_step_loop_device_us`` / ``in_step_launches`` (those inside the
    step spans alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from rsoccer_tpu_torch.utils import tracing

    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                schedule=sched) as prof:
        call()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(n_calls):
            call()
        torch.cuda.synchronize()
        prof.step()
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    spans = {name: sorted((e.start_ns(), e.end_ns()) for e in host if e.name() == name)
             for name in (tracing.ROLLOUT_STEP, tracing.ENV_KERNEL)}
    launch_at = {e.correlation_id(): e.start_ns() for e in host
                 if RUNTIME.match(e.name()) and LAUNCH.search(e.name())}

    def inside(t, name):
        if t is None:
            return False
        v = spans[name]
        i = bisect.bisect_right(v, (t, float("inf"))) - 1
        return i >= 0 and t < v[i][1]

    kernel_ns = loop_ns = step_loop_ns = 0
    launches = step_launches = 0
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        t, d = launch_at.get(e.correlation_id()), e.duration_ns()
        launches += 1
        if inside(t, tracing.ENV_KERNEL):
            kernel_ns += d
            step_launches += 1
            continue
        loop_ns += d
        if inside(t, tracing.ROLLOUT_STEP):
            step_loop_ns += d
            step_launches += 1
    steps = len(spans[tracing.ROLLOUT_STEP])
    return {"steps": steps, "launches": launches / steps, "loop_device_us": loop_ns / steps / 1e3,
            "kernel_device_us": kernel_ns / steps / 1e3, "in_step_loop_device_us": step_loop_ns / steps / 1e3,
            "in_step_launches": step_launches / steps}


def time_calls(fn, n: int, device) -> float:
    """Seconds for ``n`` calls of ``fn``: between CUDA events on the card's
    stream (waiting for the last), on the host clock on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return time.perf_counter() - t0
