"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``rsoccer_tpu_torch/csrc`` (nvcc, at
first use), holds it against its plain PyTorch version at the main path's
shapes (8192 VSS-v0 envs), drives the main path — ``BatchedEnv(VSS-v0,
8192, fused=True, fused_rng="kernel")`` through ``make_rollout_fn`` — and
times it.  Each phase prints one line; any failure exits non-zero.  The
last two lines are the kernels' JSON record and ``{"ok": true, ...}``.
Imports nothing of JAX.  Long output goes to ``chiprun_out/``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

B = 8192
N_CHECK_STEPS = 5
ROLLOUT_STEPS = 100
TIMED_ROLLOUTS = 5
TIMED_LAUNCHES = 200
ATOL = 5e-5
OUT_DIR = "chiprun_out"


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def compare_step(n, got, want, tag):
    """Kernel outputs vs plain outputs of one step.  Floats to ATOL;
    headings on the circle (a wrap at +-pi is the same angle); steps,
    terminated, truncated exactly.  Returns the largest float error."""
    from rsoccer_tpu_torch.ops.vss_full import state_size

    st_k, obs_k, aux_k = got
    st_p, obs_p, aux_p = want
    steps_row = 6 + 6 * n
    th = slice(6 + 2 * n, 6 + 3 * n)
    d = (st_k - st_p).abs()
    dth = torch.remainder(st_k[th] - st_p[th] + math.pi, 2 * math.pi) - math.pi
    d[th] = dth.abs()
    float_rows = [r for r in range(state_size(n)) if r != steps_row]
    errs = {
        "state": float(d[float_rows].max()),
        "obs": max_err(obs_k, obs_p),
        "reward": max_err(aux_k[0], aux_p[0]),
        "shaping": max_err(aux_k[3:], aux_p[3:]),
    }
    bad = {k: v for k, v in errs.items() if not v <= ATOL}
    if bad:
        raise AssertionError(f"{tag}: kernel vs plain beyond {ATOL}: {bad}")
    if not torch.equal(st_k[steps_row], st_p[steps_row]):
        raise AssertionError(f"{tag}: steps differ")
    for name, row in (("terminated", 1), ("truncated", 2)):
        if not torch.equal(aux_k[row], aux_p[row]):
            raise AssertionError(f"{tag}: {name} differ")
    return max(errs.values())


def check_kernel_vs_plain(rng_mode: str):
    """Phases 3 and 4: a few steps from a reset state, kernel and plain
    each on their own trajectory, for both step-limit settings and both
    obs variants.  Returns (max error, dones seen)."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops.philox import make_key

    worst, dones = 0.0, 0
    for max_steps in (None, 3):
        for emit_final in (False, True):
            env = rt.make("VSS-v0")
            if max_steps is not None:
                env.max_episode_steps = max_steps
            benv = BatchedEnv(env, B, device="cuda", fused=True)
            key = make_key(11, device="cuda")
            st_k, _ = benv.reset(key)
            st_p = st_k.clone()
            key_p = key.clone()
            gen = torch.Generator(device="cuda").manual_seed(5)
            for t in range(N_CHECK_STEPS):
                act = torch.rand((2, B), generator=gen, device="cuda") * 2 - 1
                if rng_mode == "kernel":
                    got = vf.vss_full_step(env, st_k, act, key=key, emit_final=emit_final)
                    rows = vf.draw_step_rows(env, key_p, B)
                else:
                    rows = vf.draw_step_rows(env, key, B)
                    got = vf.vss_full_step(env, st_k, act, *rows, emit_final=emit_final)
                want = vf.vss_full_step_plain(env, st_p, act, *rows, emit_final)
                tag = f"rng={rng_mode} max_steps={max_steps} final={emit_final} step={t}"
                worst = max(worst, compare_step(env.n_robots, got, want, tag))
                dones += int(((got[2][1] > 0.5) | (got[2][2] > 0.5)).sum())
                st_k, st_p = got[0], want[0]
            if rng_mode == "kernel" and not torch.equal(key, key_p):
                raise AssertionError("kernel and plain keys advanced differently")
    torch.cuda.synchronize()
    return worst, dones


def check_philox_words():
    """Raw device Philox words vs the torch Philox, bit for bit."""
    from rsoccer_tpu_torch.ops.philox import make_key, philox_words
    from rsoccer_tpu_torch.ops.vss_full import _library

    lib = _library()
    key = make_key(0x1234_5678_9ABC, stream=3, device="cuda")
    key[2] = (1 << 32) + 7  # exercise both step words
    n_blk = 36
    out = torch.empty((4 * n_blk, B), dtype=torch.int32, device="cuda")
    err = lib.philox_words(key.data_ptr(), out.data_ptr(), n_blk, B,
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"philox_words launch failed: cudaError {err}")
    want = philox_words(key, 4 * n_blk, B)
    got = out.to(torch.int64) & 0xFFFFFFFF
    if not torch.equal(got, want):
        raise AssertionError(
            f"Philox words differ in {int((got != want).sum())} of {got.numel()}"
        )
    return got.numel()


def time_cuda(fn, n: int) -> float:
    """Mean ms per call of ``fn`` over ``n`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_us(fn, n: int, match: str = "", table: str = "") -> tuple[float, dict]:
    """Device time per call of ``fn`` from the profiler over ``n`` calls:
    (us per call summed over the device kernels whose name holds
    ``match``, {kernel name: us per call} of the top kernels).  ``table``
    names a file under chiprun_out/ for the profiler's full table."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    if table:
        with open(os.path.join(OUT_DIR, table), "w") as fh:
            fh.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    kernels = {
        e.key: e.self_device_time_total / n
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and match in e.key
    }
    total = sum(kernels.values())
    if total <= 0:
        raise RuntimeError(f"the profiler saw no device time for {match or 'any kernel'!r}")
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])
    return total, {k[:80]: v for k, v in top.items()}


def main() -> int:
    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    # the port is imported before anything is printed: without the repo
    # beside this script the run fails here and prints no result
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.ops import _build
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops.philox import make_key

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", nvidia_smi=card, torch_name=kind,
          torch=torch.__version__, cuda=torch.version.cuda)
    os.makedirs(OUT_DIR, exist_ok=True)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path, log, nvcc_s = _build.build()
    vf._library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as fh:
        fh.write(log)
    phase("build", nvcc_seconds=nvcc_s, total_seconds=time.perf_counter() - t0,
          library=str(lib_path.name), ptxas=ptxas)

    # ---- 3./4. kernel vs plain, both RNG modes; Philox words
    err_in, dones_in = check_kernel_vs_plain("input")
    phase("kernel_vs_plain_input", B=B, steps=N_CHECK_STEPS, max_abs_err=err_in,
          atol=ATOL, dones=dones_in)
    err_k, dones_k = check_kernel_vs_plain("kernel")
    n_words = check_philox_words()
    phase("kernel_vs_plain_kernel_rng", B=B, steps=N_CHECK_STEPS,
          max_abs_err=err_k, atol=ATOL, dones=dones_k, philox_words_equal=n_words)
    if dones_in == 0 or dones_k == 0:
        raise AssertionError("no auto-reset happened inside the checked window")

    # ---- 5. main path
    env = rt.make("VSS-v0")
    benv = BatchedEnv(env, B, device="cuda", fused=True, fused_rng="kernel")
    carry = R.init_carry(benv, seed=0)
    rollout = R.make_rollout_fn(benv, ROLLOUT_STEPS)
    for _ in range(2):  # warm-up
        carry, _ = rollout(carry)
    torch.cuda.synchronize()
    vf.vss_full_step.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    episodes = 0
    t_host = time.perf_counter()
    start.record()
    for _ in range(TIMED_ROLLOUTS):
        carry, ms = rollout(carry)
        episodes += ms.episodes  # device tensor; read after the window
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t_host
    launches = vf.vss_full_step.launches
    roll_ms = start.elapsed_time(end)
    n_steps = TIMED_ROLLOUTS * ROLLOUT_STEPS
    if launches != n_steps:
        raise AssertionError(f"kernel launched {launches} times for {n_steps} steps")
    obs = carry.obs
    if tuple(obs.shape) != (env.obs_size, B) or not bool(torch.isfinite(obs).all()):
        raise AssertionError("main-path obs not finite or of the wrong shape")
    if bool((obs.abs() > torch.tensor(1.2, dtype=torch.float32)).any()):
        raise AssertionError("main-path obs outside +-1.2 (f32)")
    if not bool(torch.isfinite(carry.state).all()):
        raise AssertionError("main-path state not finite")
    episodes = int(episodes)
    if episodes <= 0:
        raise AssertionError("no episode ended in the main-path run")
    env_steps_per_s = n_steps * B / (roll_ms / 1e3)

    # kernel alone vs its plain version, same shapes, same stream: the
    # time per call seen from the host (CUDA events over back-to-back
    # calls) and the device time per call (profiler)
    st, act = carry.state, torch.rand((2, B), device="cuda") * 2 - 1
    key = make_key(3, device="cuda")
    rows = vf.draw_step_rows(env, key, B)

    def kernel_call():
        return vf.vss_full_step(env, st, act, key=key)

    def kernel_input_call():
        return vf.vss_full_step(env, st, act, *rows)

    def plain_call():
        return vf.vss_full_step_plain(env, st, act, *vf.draw_step_rows(env, key, B))

    call_us = {
        "kernel_rng": time_cuda(kernel_call, TIMED_LAUNCHES) * 1e3,
        "kernel_input": time_cuda(kernel_input_call, TIMED_LAUNCHES) * 1e3,
        "plain": time_cuda(plain_call, 20) * 1e3,
        "kernel_rng_again": time_cuda(kernel_call, TIMED_LAUNCHES) * 1e3,
    }
    kern_dev_us, _ = device_us(kernel_call, TIMED_LAUNCHES, "vss_full_kernel")
    kern_in_dev_us, _ = device_us(kernel_input_call, TIMED_LAUNCHES, "vss_full_kernel")
    plain_dev_us, plain_top = device_us(plain_call, 10)
    roll_dev_us, roll_top = device_us(lambda: rollout(carry), 1, table="profile_rollout.txt")
    rollout_us_per_step = roll_ms * 1e3 / n_steps
    phase("main_path", card=card, B=B, steps=n_steps, launches=launches,
          episodes=episodes, rollout_ms=roll_ms, host_s=host_s,
          env_steps_per_s=env_steps_per_s, rollout_us_per_step=rollout_us_per_step)
    phase("kernel_vs_plain_time", card=card, B=B, call_us=call_us,
          device_us={"kernel_rng": kern_dev_us, "kernel_input": kern_in_dev_us,
                     "plain": plain_dev_us},
          plain_top_kernels_us=plain_top)
    phase("rollout_device", card=card, steps=ROLLOUT_STEPS,
          device_us_per_step=roll_dev_us / ROLLOUT_STEPS,
          device_busy_share=roll_dev_us / ROLLOUT_STEPS / rollout_us_per_step,
          top_kernels_us_per_rollout=roll_top)

    kernels = [{
        "name": "vss_full_step",
        "route": "cuda",
        "source": "rsoccer_tpu_torch/csrc/vss_full.cu",
        "replaces": "rsoccer_tpu/ops/pallas_vss_full.py:142",
        "launches": launches,
        "max_abs_err": max(err_in, err_k),
        "ms": kern_dev_us / 1e3,
        "plain_ms": plain_dev_us / 1e3,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
