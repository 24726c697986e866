"""The rollout driver: ``make_rollout_fn`` over the program's batched env.

Set-up builds the batched env of the configuration at the traffic's batch,
resets it from a key made from the seed, and runs the traffic's warm-up
calls of ``steps_per_call`` steps each; the last of them, timed by CUDA
events, sizes the window to ``--seconds``.  The window is that many calls
of the same function, timed by CUDA events with the queue drained at its
end; the policy is uniform in [-1, 1] from a ``torch.Generator`` on the
card seeded with the seed.

The program's env is wrapped (:class:`TappedEnv`) so that the harness, from
its own files, can open a ``bench.env_step`` span around each
``BatchedEnv.step`` call (traced runs only) and copy what goes into and
out of the steps that the seed picks from the window.  After the window
the reference steps each copied input and is compared with the copied
output, in blocks of envs; the reset that started the run is compared too.
The packed state rows are read on both sides by the reference's own copy
of the layout (``reference/layout.py``).

A traced run ends in two profiled sub-windows of the traffic's
``trace_calls`` calls each: one with the host's ops and the spans
recorded, which the per-layer readers and the breakdown read, and one
with CUDA activity alone, over which the device's idle share is taken.
"""

from __future__ import annotations

import contextlib
import math
import random
import time
from typing import NamedTuple

import torch

from benchmark.harness import compare, trace

SPAN = "bench.env_step"
REF_DTYPE = torch.float32  # the reference's precision: the configuration's
TIE_DTYPE = torch.float64  # the second witness for envs the first rejects (_judge)
TIE_EPS = (1e-7, 3e-7, 1e-6, 3e-6)  # its input moves, relative to a value's magnitude
TIE_COPIES = 8  # moved copies per scale
SECOND_OPINIONS = 64  # envs of a block judged again, at most
TIE_FLOOR = 1e-4  # an env whose error passes this (or its limit, if lower) is judged again
NEAR_TIES = "near_ties"  # the compared count of envs judged again
FAULTS = ("unchanged", "half_batch", "altered")


class Capture(NamedTuple):
    state: torch.Tensor
    action: torch.Tensor
    key: torch.Tensor
    out_state: torch.Tensor
    obs: torch.Tensor
    reward: torch.Tensor
    term: torch.Tensor
    trunc: torch.Tensor


class TappedEnv:
    """The program's batched env, with a span around each step (when
    ``span``) and a copy of the steps whose index is in ``capture_at``.
    ``fault`` breaks the step's outputs underneath (tests only)."""

    def __init__(self, benv, span: bool, fault: str | None = None):
        self.benv = benv
        self.span = span
        self.fault = fault
        self.count = 0
        self.capture_at = set()
        self.captures = []

    def __getattr__(self, name):
        return getattr(self.benv, name)

    def step(self, state, actions, key):
        i = self.count
        self.count += 1
        keep = i in self.capture_at
        if keep:
            before = (state.clone(), actions.clone(), key.clone())
        with torch.profiler.record_function(SPAN) if self.span else contextlib.nullcontext():
            out = self.benv.step(state, actions, key)
        if self.fault is not None:
            out = _break(self.fault, state, out)
        if keep:
            st, obs, rew, term, trunc, _ = out
            self.captures.append(Capture(*before, st.clone(), obs.clone(), rew.clone(),
                                         term.clone(), trunc.clone()))
        return out


def _break(fault: str, state_in, out):
    st, obs, rew, term, trunc, info = out
    if fault == "unchanged":
        st = state_in
    elif fault == "half_batch":
        h = st.shape[-1] // 2
        st = torch.cat([st[:, :h], state_in[:, h:]], dim=1)
    elif fault == "altered":
        obs = obs.clone()
        obs[0, obs.shape[-1] // 3] += 0.5
    return st, obs, rew, term, trunc, info


def _blocks(n: int, size: int):
    for a in range(0, n, size):
        yield a, slice(a, min(n, a + size))


def _ref_types():
    from benchmark.reference.core import state as core_state
    from benchmark.reference.envs import ssl_static_defenders, vss

    return {"VSSState": vss.VSSState, "SDState": ssl_static_defenders.SDState,
            "WorldState": core_state.WorldState, "BallState": core_state.BallState,
            "RobotsState": core_state.RobotsState}


def _set_dtype(dt, fn, *args, **kw):
    """``fn`` with ``dt`` the default dtype (what the reference computes in)."""
    default = torch.get_default_dtype()
    torch.set_default_dtype(dt)
    try:
        return fn(*args, **kw)
    finally:
        torch.set_default_dtype(default)


def _score(errs: dict, limits: dict) -> torch.Tensor:
    """Per env (or copy): its largest error over that number's limit; a
    broken limit of 0 reads infinite."""
    out = None
    for name, e in errs.items():
        lim = limits[name]
        r = e.double() / lim if lim > 0 else torch.where(e > 0, math.inf, 0.0).double()
        out = r if out is None else torch.maximum(out, r)
    return out


def _copies(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """TIE_COPIES copies of a one-env leaf per scale of TIE_EPS, float
    leaves in TIE_DTYPE, each copy moved by its scale times a uniform draw
    in [-1, 1] times the value's magnitude (at least 1)."""
    eps = [0.0] + [e for e in TIE_EPS for _ in range(TIE_COPIES)]
    x = t.expand(*t.shape[:-1], len(eps))
    if not t.is_floating_point():
        return x.clone()
    x = x.to(TIE_DTYPE)
    u = torch.rand(x.shape, generator=gen, device=x.device, dtype=TIE_DTYPE) * 2 - 1
    return x + torch.tensor(eps, device=x.device, dtype=TIE_DTYPE) * torch.clamp_min(x.abs(), 1.0) * u


def _judge(tally: compare.Tally, got: dict, want_fn, tie_fn, width: int):
    """Add one block's per-env errors of ``got`` ({group: leaves}) against
    the reference ``want_fn(cols)`` in float32.  An env whose error there
    passes TIE_FLOOR (or a limit) is judged again by ``tie_fn(i)``: the reference in float64 on its
    inputs and on copies moved by a few float32 ulps.  It keeps the errors
    of the copy that reads best, if that reads better: float32 rounds a
    near-tie (a contact or a wrap at its threshold) one way in the program
    and the other in the plain step on some envs in ten million, and an
    answer is right if the exact step gives it for an input within
    rounding of the one the program was given.  A block with more than
    SECOND_OPINIONS such envs is not judged again.

    Every env judged again counts towards NEAR_TIES, which has a limit of
    its own, so that a step that breeds near-ties fails however the second
    look reads them; ``tally.excused`` counts the envs that broke a limit
    in float32 and keep none broken after the second look."""
    want = want_fn(slice(0, width))
    errs = {}
    for g in got:
        errs.update(compare.env_errors(g, got[g], want[g]))
    floor = {k: min(v, TIE_FLOOR) for k, v in tally.limits.items()}
    idx = torch.nonzero(compare.over(errs, floor)).flatten().tolist()
    tally.count(NEAR_TIES, len(idx))
    if len(idx) <= SECOND_OPINIONS:
        for i in idx:
            alt = tie_fn(i)
            e2 = {}
            for g in got:
                k = next(iter(alt[g].values())).shape[-1]
                one = {p: v[..., i:i + 1].expand(*v.shape[:-1], k) for p, v in got[g].items()}
                e2.update(compare.env_errors(g, one, alt[g]))
            sc = _score(e2, tally.limits)
            j = int(sc.argmin())
            before = _score({n: e[i:i + 1] for n, e in errs.items()}, tally.limits)[0]
            if sc[j] < before:
                for name in errs:
                    errs[name][i] = e2[name][j].to(errs[name].dtype)
                tally.excused += int(before > 1 >= sc[j])
    tally.add(errs)


def check(benv, cfg: dict, traffic: dict, start, captures, tally: compare.Tally,
          dtype: torch.dtype | None = None):
    """Hold the start's reset and each captured step to the reference, from
    the program's inputs, in blocks of envs (``_judge``).  With ``dtype``
    the reference computed in that type stands in the program's place (the
    control)."""
    from benchmark.reference import envstep, layout

    n = benv.n_envs
    size = traffic["check_block"]
    key0, state0, obs0 = start
    types = _ref_types()
    envs = {dt: _set_dtype(dt, envstep.make, cfg["env_id"], **cfg["env_kwargs"])
            for dt in (REF_DTYPE, TIE_DTYPE, dtype) if dt is not None}
    if layout.rows(envs[REF_DTYPE]) != cfg["state_rows"]:
        raise ValueError(f"the layout has {layout.rows(envs[REF_DTYPE])} rows, the configuration "
                         f"{cfg['state_rows']}")

    def unpack(rows):
        return layout.unpack(envs[REF_DTYPE], rows)

    def reset(dt, a, cols):
        st, obs = _set_dtype(dt, envstep.reset, envs[dt], key0, cols.stop - cols.start,
                             env_base=a + cols.start)
        return {"start": compare.flatten(st), "start_obs": {"obs": obs}}

    for a, block in _blocks(n, size):
        tally.base = a
        width = block.stop - a
        if dtype is None:
            got = {"start": compare.flatten(unpack(state0[:, block])),
                   "start_obs": {"obs": obs0[:, block]}}
        else:
            got = reset(dtype, a, slice(0, width))
        _judge(tally, got, lambda cols, a=a: reset(REF_DTYPE, a, cols),
               lambda i, a=a: reset(TIE_DTYPE, a, slice(i, i + 1)), width)

    def outputs(st, obs, rew, term, trunc):
        return {"state": compare.flatten(st), "obs": {"obs": obs}, "reward": {"reward": rew},
                "flag": {"term": term, "trunc": trunc}}

    gen = torch.Generator(device=benv.device)
    for cap in captures:
        for a, block in _blocks(n, size):
            tally.base = a
            width = block.stop - a
            s_in = unpack(cap.state[:, block])
            act = cap.action[:, block]

            def step(cols, dt=REF_DTYPE, s_in=s_in, act=act, a=a):
                s = compare.rebuild(s_in, types, lambda t: t[..., cols].to(dt) if t.is_floating_point()
                                    else t[..., cols])
                st, obs, rew, term, trunc, _ = _set_dtype(dt, envstep.step, envs[dt], s, act[:, cols].to(dt),
                                                          cap.key, env_base=a + cols.start)
                return outputs(st, obs, rew, term, trunc)

            def tie(i, s_in=s_in, act=act, a=a):
                gen.manual_seed(a + i)
                s = compare.rebuild(s_in, types, lambda t: _copies(t[..., i:i + 1], gen))
                acts = _copies(act[:, i:i + 1], gen)
                env = envs[TIE_DTYPE]
                t_noise, r_noise = _set_dtype(TIE_DTYPE, envstep.noise, env, cap.key, 1, env_base=a + i)
                k = acts.shape[-1]
                t_noise, r_noise = ({name: v.expand(*v.shape[:-1], k) for name, v in d.items()}
                                    for d in (t_noise, r_noise))
                st, obs, rew, term, trunc, _ = _set_dtype(TIE_DTYPE, env.step_with_noise, s, acts, t_noise,
                                                          r_noise)
                return outputs(st, obs, rew, term, trunc)

            if dtype is None:
                got = outputs(unpack(cap.out_state[:, block]), cap.obs[:, block],
                              cap.reward[block], cap.term[block], cap.trunc[block])
            else:
                got = step(slice(0, width), dtype)
            _judge(tally, got, step, tie, width)


def _pace(e0, h0: float, ends: list) -> dict:
    """How the window's untraced calls ran on the device: each call's
    device milliseconds (from one call's end to the next), the time above
    the median in calls over 1.25 times it (where the device waited on a
    host that stood still), and how far ahead of the device the host sent
    each call.  ``ends`` holds None where profiled calls came between."""
    done = [None if e is None else e0.elapsed_time(e[1]) for e in ends]
    per = sorted(b - a for a, b in zip(done, done[1:]) if a is not None and b is not None)
    if not per:
        return {}
    med = per[len(per) // 2]
    ahead = sorted(d - (e[0] - h0) * 1e3 for e, d in zip(ends, done) if e is not None)
    return {"calls": len(ahead), "call_ms_median": med, "call_ms_max": per[-1],
            "slow_excess_ms": sum(p - med for p in per if p > 1.25 * med),
            "ahead_ms_least": ahead[0], "ahead_ms_median": ahead[len(ahead) // 2]}


def run(ctx) -> dict:
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.ops.philox import make_key

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    on_card = dev.type == "cuda"
    n, steps = tr["n_envs"], tr["steps_per_call"]
    benv = rt.make_vec(cfg["env_id"], n, device=dev, fused=True, fused_rng=tr["fused_rng"],
                       **cfg["env_kwargs"])
    key = make_key(ctx.seed, stream=0, device=dev)
    key0 = key.clone()
    state, obs = benv.reset(key)
    start = (key0, state.clone(), obs.clone())
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    zeros = torch.zeros((n,), device=dev)
    carry = R.RolloutCarry(state, obs, key, gen, zeros, zeros.clone())
    del state, obs
    tap = TappedEnv(benv, span=False, fault=ctx.fault)
    roll = R.make_rollout_fn(tap, steps)

    for _ in range(tr["warmup_calls"] - 1):
        carry, _ = roll(carry)
    t_call = ctx.seconds
    if on_card:  # the last warm-up call, timed, sizes the window
        t = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t[0].record()
    carry, _ = roll(carry)
    if on_card:
        t[1].record()
        t[1].synchronize()
        t_call = t[0].elapsed_time(t[1]) / 1e3
    n_calls = max(tr["min_calls"], round(ctx.seconds / t_call))
    k = tr["trace_calls"]
    if ctx.trace:  # two profiled sub-windows, each after a call traced and dropped, and two calls alone
        n_calls = max(n_calls, 2 * (k + 1) + 2)
    first = tap.count
    picks = random.Random(ctx.seed).sample(range(tr["min_calls"] * steps), tr["checked_steps"])
    tap.capture_at = {first + p for p in picks}

    window = None
    record = {"config": cfg, "traffic": tr, "n_envs": n}
    setup_s = ctx.since_start()
    if on_card:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        h0 = time.perf_counter()
    ends = []  # (host second at which an untraced call was sent, a CUDA event after it)

    def one_call():
        nonlocal carry
        carry, _ = roll(carry)

    resets = {}  # span -> the envs that k profiled calls reset

    def calls(span=None):
        nonlocal carry
        eps = zeros.new_zeros(())
        with torch.profiler.record_function(span) if span else contextlib.nullcontext():
            for _ in range(k):
                carry, ms = roll(carry)
                eps = eps + ms.episodes
            torch.cuda.synchronize()
        resets[span] = float(eps)

    done = 0
    while done < n_calls:
        # the profiled sub-windows come last
        if ctx.trace and window is None and done == n_calls - 2 * (k + 1):
            tap.span = True  # only the first sub-window's calls pay for the spans
            window = trace.read(trace.profiled(one_call, lambda: calls(trace.WINDOW)))
            tap.span = False
            record.update(window=window, profiled_steps=k * steps, profiled_resets=resets[trace.WINDOW],
                          device_busy=trace.device_busy(one_call, calls))
            done += 2 * (k + 1)
            ends.append(None)  # no call's own time spans the profiled sub-windows
            continue
        carry, _ = roll(carry)
        done += 1
        if on_card:
            ends.append((time.perf_counter(), torch.cuda.Event(enable_timing=True)))
            ends[-1][1].record()
    if on_card:
        e1.record()
        e1.synchronize()
        secs = e0.elapsed_time(e1) / 1e3
        record["pace"] = _pace(e0, h0, ends)
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        secs, peak = float("nan"), 0
    env_steps = n_calls * steps * n
    del carry, roll
    if on_card:
        torch.cuda.empty_cache()

    tally = compare.Tally(ctx.limits)
    t0 = time.perf_counter()
    check(benv, cfg, tr, start, tap.captures, tally)
    record["check_s"] = time.perf_counter() - t0
    controls = {}
    for dtype in ctx.controls:
        controls[str(dtype)] = compare.Tally(ctx.limits)
        check(benv, cfg, tr, start, tap.captures, controls[str(dtype)], dtype=dtype)
    return {
        "end_to_end": {"env_steps_per_s": env_steps / secs, "setup_s": setup_s},
        "record": record,
        "tally": tally,
        "controls": controls,
        "attempted": env_steps,
        "memory_peak_bytes": peak,
        "window": window,
    }
