"""Profiled sub-windows under ``torch.profiler``, read into device time.

The arithmetic of ``rsoccer_tpu_torch/tools/_trace.py`` (kernel time by
name, launches, the busy time as the union of the kernels' intervals),
copied so that a later change to the program leaves the yardstick as it
is, and extended by the spans:

- the window is the ``bench.window`` span the driver opens around the
  profiled calls, which ends after a ``torch.cuda.synchronize``;
- a kernel belongs to each ``bench.*`` span inside which the host
  launched it: its launch (the runtime call that carries the kernel's
  correlation id) lies within the span on the host's timeline;
- an idle gap is an interval of the window in which no kernel ran,
  labelled by what the host was doing when it began: the innermost
  ``bench.*`` span and the innermost op around that moment.

The device's idle share comes from a second sub-window of its own
(:func:`device_busy`), profiled with CUDA activity alone: there the host
records no ops and runs as it does untraced, where under the first
sub-window's op recording its Python falls behind the device.

On the card the profiler has been seen to drop the first launches it
traces, so both run one call traced and dropped first.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

import torch

WINDOW = "bench.window"
# the runtime calls that enqueue device work
LAUNCH = re.compile(r"launch|memcpy|memset", re.IGNORECASE)
RUNTIME = re.compile(r"^(cuda|cu)[A-Z]")
TOP = 10  # entries of each breakdown list
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length


@dataclasses.dataclass
class Window:
    """What one profiled sub-window holds, in seconds."""

    kernels: dict  # name -> [seconds, launches], largest first
    span_count: dict  # span name -> occurrences
    span_device_s: dict  # span name -> device seconds of the kernels launched inside it
    span_launches: dict  # span name -> kernels launched inside it
    gaps: list  # [label, seconds] of idle time, largest first

    def breakdown(self) -> dict:
        return {"device_ops": [[k[:NAME_CHARS], s] for k, (s, _) in list(self.kernels.items())[:TOP]],
                "idle_gaps": self.gaps[:TOP]}


def _union(intervals) -> list:
    """Merged [start, end] intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profiled(warm, window, host: bool = True):
    """Run ``warm()`` traced and dropped, then ``window()`` under the
    profiler, with the host's ops recorded where ``host``; returns the
    profiler."""
    from torch.profiler import ProfilerActivity

    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        window()
        torch.cuda.synchronize()
        prof.step()
    return prof


def _device_events(prof) -> list:
    """The device operations of ``prof``'s recorded events (kernels,
    copies, sets), without the annotations that mirror host spans."""
    from torch.autograd import DeviceType

    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
            and not e.name().startswith("bench.")]


def device_busy(warm, window):
    """``(busy_s, window_s)`` of ``window()`` profiled with CUDA activity
    alone, after ``warm()`` traced and dropped: the union of the device
    operations' intervals, and the window from the first one's start to
    the last one's end, so that busy never exceeds the window.  None where
    the trace holds no device operation."""
    ops = _device_events(profiled(warm, window, host=False))
    if not ops:
        return None
    busy = _union((e.start_ns(), e.start_ns() + e.duration_ns()) for e in ops)
    return sum(b - a for a, b in busy) * 1e-9, (busy[-1][1] - busy[0][0]) * 1e-9


def read(prof) -> Window:
    """The window of ``prof``'s recorded events."""
    from torch.autograd import DeviceType

    host = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CPU]
    device = _device_events(prof)
    wins = [e for e in host if e.name() == WINDOW]
    if len(wins) != 1:
        raise RuntimeError(f"the trace holds {len(wins)} {WINDOW} spans, not 1")
    w0, w1 = wins[0].start_ns(), wins[0].end_ns()
    launch_at = {e.correlation_id(): e.start_ns() for e in host
                 if RUNTIME.match(e.name()) and LAUNCH.search(e.name())}
    spans = {}
    for e in host:
        if e.name().startswith("bench.") and e.name() != WINDOW and w0 <= e.start_ns() < w1:
            spans.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for v in spans.values():
        v.sort()
    starts = {k: [a for a, _ in v] for k, v in spans.items()}

    kernels, intervals = {}, []
    span_s = dict.fromkeys(spans, 0.0)
    span_n = dict.fromkeys(spans, 0)
    for k in device:
        a, d = k.start_ns(), k.duration_ns()
        if a < w0 or a + d > w1:
            continue
        intervals.append((a, a + d))
        row = kernels.setdefault(k.name(), [0.0, 0])
        row[0] += d * 1e-9
        row[1] += 1
        t = launch_at.get(k.correlation_id())
        if t is None:
            continue
        for name, v in spans.items():
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and t < v[i][1]:
                span_s[name] += d * 1e-9
                span_n[name] += 1
    return Window(
        kernels=dict(sorted(kernels.items(), key=lambda kv: -kv[1][0])),
        span_count={k: len(v) for k, v in spans.items()},
        span_device_s=span_s,
        span_launches=span_n,
        gaps=_gaps(_union(intervals), w0, w1, host, wins[0].start_thread_id()),
    )


def _gaps(busy, w0, w1, host, tid) -> list:
    """Idle time of the window by what the host's main thread was doing as
    each gap began: a sweep over its properly nested events."""
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = sorted((a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a)
    ops = sorted((e.start_ns(), -e.end_ns(), e.name()) for e in host
                 if e.start_thread_id() == tid and e.name() != WINDOW and not RUNTIME.match(e.name())
                 and not e.name().startswith("ProfilerStep"))
    spans, inner = [], []
    by_label = {}
    i = 0
    for a, b in gaps:
        while i < len(ops) and ops[i][0] <= a:
            st, neg_end, name = ops[i]
            stack = spans if name.startswith("bench.") else inner
            while stack and stack[-1][0] <= st:
                stack.pop()
            stack.append((-neg_end, name))
            i += 1
        for stack in (spans, inner):
            while stack and stack[-1][0] <= a:
                stack.pop()
        label = f"{spans[-1][1] if spans else 'outside spans'} / {inner[-1][1] if inner else 'python'}"
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-9
    return sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])
