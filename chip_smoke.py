"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rsoccer_tpu_torch/csrc`` (one nvcc per
source, in parallel, at first use) and, for each fused env step —
VSS-v0 (``vss_full_step``), SSLStaticDefenders-v0 (``ssl_sd_full_step``)
and SSLContestedPossession-v0 (``ssl_cp_full_step``) — holds the kernel
against its plain PyTorch version at the main path's shapes (8192 envs),
in both RNG modes and both obs variants, through auto-resets.  Then it
drives each main path — ``BatchedEnv(<id>, 8192, device="cuda", fused=True,
fused_rng="kernel")`` through ``make_rollout_fn`` — with every launch count
set to 0 just before and read just after, and times it.  Each phase prints
one line; any failure exits non-zero.  The
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
from types import SimpleNamespace

import torch

B = 8192
N_CHECK_STEPS = 5
WARM_STEPS = 60  # SSL checks start mid-episode: contacts, dribbling, kicks
ROLLOUT_STEPS = 100
TIMED_ROLLOUTS = 5
TIMED_LAUNCHES = 200
ATOL = 5e-5
OUT_DIR = "chiprun_out"
# the least time the card could take (H100 SXM data sheet, 700 W): bytes
# over the HBM rate, f32 operations over the non-tensor-core f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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
    st_k, obs_k, aux_k = got
    st_p, obs_p, aux_p = want
    steps_row = 6 + 6 * n
    th = slice(6 + 2 * n, 6 + 3 * n)
    d = (st_k - st_p).abs()
    dth = torch.remainder(st_k[th] - st_p[th] + math.pi, 2 * math.pi) - math.pi
    d[th] = dth.abs()
    float_rows = [r for r in range(st_k.shape[0]) if r != steps_row]
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


def chase_actions(obs, gen):
    """SSL actions: even envs run at the ball with the dribbler on, odd
    envs act at random; both kick at random."""
    u = torch.rand((5, obs.shape[-1]), generator=gen, device=obs.device) * 2 - 1
    dx, dy = obs[0] - obs[4], obs[1] - obs[5]
    norm = torch.sqrt(dx * dx + dy * dy) + 1e-6
    chase = torch.arange(obs.shape[-1], device=obs.device) % 2 == 0
    u[0] = torch.where(chase, dx / norm, u[0])
    u[1] = torch.where(chase, dy / norm, u[1])
    u[4] = torch.where(chase, 1.0, u[4])
    return u


def check_kernel_vs_plain(task, rng_mode: str):
    """A few steps, kernel and plain each on their own trajectory, for
    both step-limit settings and both obs variants.  VSS-v0 starts from a
    reset state with random actions; the SSL tasks start after WARM_STEPS
    kernel steps of the chase policy (the actions of the checked steps
    come from the kernel's obs and go to both).  Returns (max error, dones
    seen)."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.ops.philox import make_key

    worst, dones = 0.0, 0
    for max_steps in (None, 3):
        for emit_final in (False, True):
            env = rt.make(task.env_id)
            if max_steps is not None:
                env.max_episode_steps = max_steps
            benv = BatchedEnv(env, B, device="cuda", fused=True, fused_rng="kernel")
            key = make_key(11, device="cuda")
            st_k, obs = benv.reset(key)
            gen = torch.Generator(device="cuda").manual_seed(5)
            for _ in range(task.warm_steps):
                st_k, obs, *_ = benv.step(st_k, task.actions(obs, gen), key)
            st_p = st_k.clone()
            key_p = key.clone()
            for t in range(N_CHECK_STEPS):
                act = task.actions(obs, gen)
                if rng_mode == "kernel":
                    got = task.wrapper(env, st_k, act, key=key, emit_final=emit_final)
                    rows = task.draw(env, key_p, B)
                else:
                    rows = task.draw(env, key, B)
                    got = task.wrapper(env, st_k, act, *rows, emit_final=emit_final)
                want = task.plain(env, st_p, act, *rows, emit_final)
                tag = (f"{task.name} rng={rng_mode} max_steps={max_steps} "
                       f"final={emit_final} step={t}")
                worst = max(worst, compare_step(env.n_robots, got, want, tag))
                dones += int(((got[2][1] > 0.5) | (got[2][2] > 0.5)).sum())
                st_k, st_p = got[0], want[0]
                obs = got[1][:env.obs_size]
            if rng_mode == "kernel" and not torch.equal(key, key_p):
                raise AssertionError(f"{task.name}: kernel and plain keys advanced differently")
    torch.cuda.synchronize()
    if dones == 0:
        raise AssertionError(f"{task.name} rng={rng_mode}: no auto-reset inside the checked window")
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


def bound_ms(task, ins, outs) -> tuple[float, str, float, float]:
    """The least time for one step on these inputs: each input read once
    and each output written once over the HBM rate, against the f32
    operations over the f32 rate.  Returns (bound, "bytes" or
    "operations", bytes time, operations time), in ms.  Operations: task.ops_env per env
    plus task.ops_reset per lane that this call resets (counted from the
    kernel source: one per f32 add, multiply, divide, compare, min/max,
    square root or transcendental; each Philox block as 40)."""
    n_bytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    aux = outs[-1]
    n_done = int(((aux[1] > 0.5) | (aux[2] > 0.5)).sum())
    n_ops = task.ops_env * ins[0].shape[-1] + task.ops_reset * n_done
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops


def main_path(task, tasks, card):
    """Drive the task's main path with every launch count zeroed just
    before and read just after; time it, its kernel and its plain version.
    Returns the kernel's record for the final JSON line (without
    max_abs_err)."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.ops.philox import make_key

    env = rt.make(task.env_id)
    benv = BatchedEnv(env, B, device="cuda", fused=True, fused_rng="kernel")
    carry = R.init_carry(benv, seed=0)
    rollout = R.make_rollout_fn(benv, ROLLOUT_STEPS)
    for _ in range(2):  # warm-up
        carry, _ = rollout(carry)
    torch.cuda.synchronize()
    for t in tasks:
        t.wrapper.launches = 0
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
    launches = {t.name: t.wrapper.launches for t in tasks}
    roll_ms = start.elapsed_time(end)
    n_steps = TIMED_ROLLOUTS * ROLLOUT_STEPS
    want = {t.name: (n_steps if t is task else 0) for t in tasks}
    if launches != want:
        raise AssertionError(f"{task.name} main path: launches {launches}, want {want}")
    obs = carry.obs
    if tuple(obs.shape) != (env.obs_size, B) or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"{task.name}: main-path obs not finite or of the wrong shape")
    if bool((obs.abs() > torch.tensor(1.2, dtype=torch.float32)).any()):
        raise AssertionError(f"{task.name}: main-path obs outside +-1.2 (f32)")
    if not bool(torch.isfinite(carry.state).all()):
        raise AssertionError(f"{task.name}: main-path state not finite")
    episodes = int(episodes)
    if episodes <= 0:
        raise AssertionError(f"{task.name}: no episode ended in the main-path run")
    env_steps_per_s = n_steps * B / (roll_ms / 1e3)

    # kernel alone vs its plain version, same shapes, same stream: the
    # time per call seen from the host (CUDA events over back-to-back
    # calls) and the device time per call (profiler)
    st = carry.state
    act = task.actions(carry.obs, torch.Generator(device="cuda").manual_seed(7))
    key = make_key(3, device="cuda")
    rows = task.draw(env, key, B)

    def kernel_call():
        return task.wrapper(env, st, act, key=key)

    def kernel_input_call():
        return task.wrapper(env, st, act, *rows)

    def plain_call():
        return task.plain(env, st, act, *task.draw(env, key, B))

    call_us = {
        "kernel_rng": time_cuda(kernel_call, TIMED_LAUNCHES) * 1e3,
        "kernel_input": time_cuda(kernel_input_call, TIMED_LAUNCHES) * 1e3,
        "plain": time_cuda(plain_call, 20) * 1e3,
        "kernel_rng_again": time_cuda(kernel_call, TIMED_LAUNCHES) * 1e3,
    }
    kern_dev_us, _ = device_us(kernel_call, TIMED_LAUNCHES, task.kernel_match)
    kern_in_dev_us, _ = device_us(kernel_input_call, TIMED_LAUNCHES, task.kernel_match)
    plain_dev_us, plain_top = device_us(plain_call, 10)
    roll_dev_us, roll_top = device_us(lambda: rollout(carry), 1,
                                      table=f"profile_rollout_{task.name}.txt")
    rollout_us_per_step = roll_ms * 1e3 / n_steps
    outs = kernel_call()
    bound, bound_by, bytes_ms, ops_ms = bound_ms(task, (st, act, key), outs)
    bound_in = bound_ms(task, (st, act, *rows), outs)
    phase(f"main_path_{task.name}", card=card, env=task.env_id, B=B, steps=n_steps,
          launches=launches[task.name], episodes=episodes, rollout_ms=roll_ms, host_s=host_s,
          env_steps_per_s=env_steps_per_s, rollout_us_per_step=rollout_us_per_step)
    phase(f"kernel_vs_plain_time_{task.name}", card=card, B=B, call_us=call_us,
          device_us={"kernel_rng": kern_dev_us, "kernel_input": kern_in_dev_us,
                     "plain": plain_dev_us},
          bound_us=bound * 1e3, bound_by=bound_by, bound_bytes_us=bytes_ms * 1e3,
          bound_ops_us=ops_ms * 1e3, bound_input_rows_us=bound_in[0] * 1e3,
          bound_input_rows_by=bound_in[1], plain_top_kernels_us=plain_top)
    phase(f"rollout_device_{task.name}", card=card, steps=ROLLOUT_STEPS,
          device_us_per_step=roll_dev_us / ROLLOUT_STEPS,
          device_busy_share=roll_dev_us / ROLLOUT_STEPS / rollout_us_per_step,
          top_kernels_us_per_rollout=roll_top)
    return {
        "name": task.name,
        "route": "cuda",
        "source": task.source,
        "replaces": task.replaces,
        "launches": launches[task.name],
        "ms": kern_dev_us / 1e3,
        "plain_ms": plain_dev_us / 1e3,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes an env step
    }


def main() -> int:
    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    # the port is imported before anything is printed: without the repo
    # beside this script the run fails here and prints no result
    from rsoccer_tpu_torch.ops import _build
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops import vss_full as vf

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", nvidia_smi=card, torch_name=kind,
          torch=torch.__version__, cuda=torch.version.cuda)
    os.makedirs(OUT_DIR, exist_ok=True)

    def random_actions(n):
        return lambda obs, gen: torch.rand((n, obs.shape[-1]), generator=gen, device=obs.device) * 2 - 1

    tasks = [
        SimpleNamespace(
            name="vss_full_step", env_id="VSS-v0", wrapper=vf.vss_full_step,
            plain=vf.vss_full_step_plain, draw=vf.draw_step_rows,
            actions=random_actions(2), warm_steps=0, kernel_match="vss_full_kernel",
            source="rsoccer_tpu_torch/csrc/vss_full.cu",
            replaces="rsoccer_tpu/ops/pallas_vss_full.py:142",
            # OU + wheels ~100, 5 substeps x (6 robots x 30 + 15 pairs x 25
            # + walls 48 + ball 60 + 6 contacts x 20), spawn ~900 and 36
            # Philox blocks on every lane, obs ~60
            ops_env=100 + 5 * (180 + 375 + 48 + 60 + 120) + 900 + 36 * 40 + 60, ops_reset=0,
        ),
        SimpleNamespace(
            name="ssl_sd_full_step", env_id="SSLStaticDefenders-v0", wrapper=sf.sd_full_step,
            plain=sf.sd_full_step_plain, draw=sf.sd_draw_step_rows,
            actions=chase_actions, warm_steps=WARM_STEPS, kernel_match="sd_full_kernel",
            source="rsoccer_tpu_torch/csrc/ssl_full.cu",
            replaces="rsoccer_tpu/ops/pallas_ssl_full.py:456",
            # trig + actions ~40, 5 substeps x (7 robots x 20 + 21 pairs x 25
            # + ball 45 + 7 contacts x 20 + 2 face zones x 12), shaping and
            # obs ~120; a reset: ball 8 x 6, defenders 6 x 8 x (4.5 x 5 + 4),
            # 30 Philox blocks
            ops_env=40 + 5 * (140 + 525 + 45 + 140 + 24) + 120,
            ops_reset=48 + 6 * 8 * 27 + 30 * 40,
        ),
        SimpleNamespace(
            name="ssl_cp_full_step", env_id="SSLContestedPossession-v0", wrapper=sf.cp_full_step,
            plain=sf.cp_full_step_plain, draw=sf.cp_draw_step_rows,
            actions=chase_actions, warm_steps=WARM_STEPS, kernel_match="cp_full_kernel",
            source="rsoccer_tpu_torch/csrc/ssl_full.cu",
            replaces="rsoccer_tpu/ops/pallas_ssl_full.py:824",
            # trig + actions ~25, 5 substeps x (2 robots x 20 + 1 pair x 25
            # + ball 45 + 2 contacts x 20 + 2 face zones x 12), epilogue ~110;
            # a reset: ~10 and one Philox block
            ops_env=25 + 5 * (40 + 25 + 45 + 40 + 24) + 110, ops_reset=10 + 40,
        ),
    ]

    # ---- 2. build: one nvcc per source, all at once, then one link
    t0 = time.perf_counter()
    lib_path, log, nvcc_s = _build.build()
    vf._library()
    sf._library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as fh:
        fh.write(log)
    phase("build", nvcc_seconds=nvcc_s, total_seconds=time.perf_counter() - t0,
          library=str(lib_path.name), ptxas=ptxas)

    # ---- 3. each kernel vs its plain version, both RNG modes
    errs = {}
    for task in tasks:
        err_in, dones_in = check_kernel_vs_plain(task, "input")
        phase(f"kernel_vs_plain_input_{task.name}", B=B, steps=N_CHECK_STEPS,
              max_abs_err=err_in, atol=ATOL, dones=dones_in)
        err_k, dones_k = check_kernel_vs_plain(task, "kernel")
        extra = {"philox_words_equal": check_philox_words()} if task is tasks[0] else {}
        phase(f"kernel_vs_plain_kernel_rng_{task.name}", B=B, steps=N_CHECK_STEPS,
              max_abs_err=err_k, atol=ATOL, dones=dones_k, **extra)
        errs[task.name] = max(err_in, err_k)

    # ---- 4. each main path, through its kernel, timed
    kernels = []
    for task in tasks:
        rec = main_path(task, tasks, card)
        rec["max_abs_err"] = errs[task.name]
        kernels.append(rec)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
