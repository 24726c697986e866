"""Spans, launch counters and set-up phases of the port, for an operator
running ``torch.profiler``.

**Spans.** :func:`span` opens a profiler event of the function scope
(``torch._C._profiler._RecordFunctionFast``) only while a profiler is
running (``torch.autograd.profiler``'s ``_is_profiler_enabled``, a module
flag); otherwise it returns one shared null context, so a span costs a
flag check when nothing traces.  Under a profiler that records the host's
ops, a span is a host event whose start and end kineto stamps in epoch
nanoseconds, the clock of the device trace's kernels, and every kernel the
host launches inside it carries the correlation id of a runtime call that
lies within it.  Unlike ``torch.profiler.record_function``'s user scope,
the function scope puts no mirror of the span on the device's timeline,
and costs the host about an eighth as much.  Under a profiler of CUDA activity
alone a span is entered and records nothing.  The spans of a rollout, each
inside the one before it but ``rsoccer.policy``, which sits beside
``rsoccer.env.step``:

- ``rsoccer.rollout.step``: one step of ``batch/rollout.make_rollout_fn``'s
  loop (the policy, the env step, the step's bookkeeping: the epilogue
  kernel on the card, the metrics and their sum on the CPU);
- ``rsoccer.policy``: the policy's draw of the step's actions;
- ``rsoccer.env.step``: ``BatchedEnv.step`` and ``BatchedEnv.step_final``;
- ``rsoccer.env.kernel``: a fused step's call (``fused=True``): the
  kernel's launch, its outputs' allocation and the key's advance on the
  card, the plain step on the CPU.

**Counters.** :data:`counters` is one table, always on, that the kernel
wrappers and the set-up phases add to:

- ``("launch", wrapper, entry, emit_final)``: the kernel launches of a
  fused wrapper (``vss_full_step``, ``sd_full_step``, ``cp_full_step``,
  ``dr_full_step``, ``pe_full_step``, ``vss_physics``) by C entry and by
  whether the ``emit_final`` variant ran; :func:`launches` and
  :func:`entry_launches` sum them;
- ``("launch", "rollout_epilogue", entry, False)``: the rollout loop's
  bookkeeping kernels on the card (``ops/rollout_epilogue.py``), C entry
  ``rollout_epilogue`` once a step and ``rollout_epilogue_finish`` once a
  ``make_rollout_fn`` call; none on the CPU, where the plain torch
  bookkeeping runs;
- ``("phase", name, field)``: a :func:`phase`'s ``count``, its total
  ``seconds`` and its ``first_start_ns`` (``time.time_ns()``, the
  profiler's clock); the library's phase adds ``builds`` (0 where the
  library was already built) and nvcc's ``build_s``.  :func:`phases`
  groups them.

**Set-up phases**, one-off work timed whether or not a profiler runs:
``rsoccer.setup.library`` (``ops/_build.load``: the sources' hash, nvcc
where the library is missing, ``dlopen``, the C entries' types),
``rsoccer.setup.make_vec`` (``rsoccer_tpu_torch.make_vec``) and
``rsoccer.setup.reset`` (``BatchedEnv.reset``).

:func:`snapshot` returns a copy of the table.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

ROLLOUT_STEP = "rsoccer.rollout.step"
POLICY = "rsoccer.policy"
ENV_STEP = "rsoccer.env.step"
ENV_KERNEL = "rsoccer.env.kernel"
SETUP_LIBRARY = "rsoccer.setup.library"
SETUP_MAKE_VEC = "rsoccer.setup.make_vec"
SETUP_RESET = "rsoccer.setup.reset"

counters: collections.Counter = collections.Counter()

_NULL = contextlib.nullcontext()
_record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A host event ``name`` while a profiler runs, else a shared null
    context."""
    if _profiler._is_profiler_enabled:
        return _record(name)
    return _NULL


@contextlib.contextmanager
def phase(name: str):
    """Time one-off work into the table (count, seconds, first start) and,
    while a profiler runs, open the same-named span."""
    t0 = time.time_ns()
    first = ("phase", name, "first_start_ns")
    if first not in counters:
        counters[first] = t0
    try:
        with span(name):
            yield
    finally:
        add(name, "count", 1)
        add(name, "seconds", (time.time_ns() - t0) * 1e-9)


def add(phase_name: str, field: str, value):
    """Add ``value`` to a phase's ``field`` in the table."""
    counters["phase", phase_name, field] += value


def launched(wrapper: str, entry: str, emit_final: bool):
    """Count one launch of ``wrapper``'s kernel through the C ``entry``."""
    counters["launch", wrapper, entry, bool(emit_final)] += 1


def snapshot() -> dict:
    """A copy of the table."""
    return dict(counters)


def _since(since):
    now = snapshot()
    if since:
        for k, v in since.items():
            now[k] = now.get(k, 0) - v
    return now


def _name(wrapper) -> str:
    return wrapper if isinstance(wrapper, str) else wrapper.__name__


def launches(wrapper, entry: str | None = None, final: bool | None = None, *,
             since: dict | None = None) -> int:
    """``wrapper``'s launches (a wrapper or its name), through ``entry`` and
    of the ``emit_final`` variant or not where given, counted since the
    snapshot ``since`` where given."""
    w = _name(wrapper)
    return sum(v for k, v in _since(since).items()
               if k[0] == "launch" and k[1] == w and entry in (None, k[2]) and final in (None, k[3]))


def entry_launches(wrapper, *, since: dict | None = None) -> dict:
    """``{C entry: launches}`` of ``wrapper``, entries that launched only."""
    w = _name(wrapper)
    out = collections.Counter()
    for k, v in _since(since).items():
        if k[0] == "launch" and k[1] == w:
            out[k[2]] += v
    return {k: v for k, v in out.items() if v}


def clear_launches():
    """Drop every launch count from the table (the phases stay)."""
    for k in [k for k in counters if k[0] == "launch"]:
        del counters[k]


def phases(table: dict | None = None) -> dict:
    """``{phase name: {field: value}}`` of ``table`` (default: now)."""
    out = {}
    for k, v in (snapshot() if table is None else table).items():
        if k[0] == "phase":
            out.setdefault(k[1], {})[k[2]] = v
    return out
