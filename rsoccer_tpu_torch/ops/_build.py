"""Build and load the port's CUDA kernels.

nvcc compiles every ``csrc/*.cu`` into ONE shared library with a plain C
interface, which ctypes loads: one nvcc process per source, all started
together, then one link.  The library goes to
``rsoccer_tpu_torch/_build/`` under a name keyed by a hash of the sources
and the flags, at first use (nothing is built when a module is imported),
so a fresh checkout builds it on the first launch and an edited source
rebuilds.  No PyTorch headers are compiled: the C entries take raw device
pointers, ``B`` and the stream, and return a ``cudaError_t``.

A failed build raises with nvcc's output; nothing falls back to a plain
version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from rsoccer_tpu_torch.utils import tracing

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # keep each multiply and add rounded as the plain version's separate
    # ops are (see csrc/vss_world.cuh); no --use_fast_math
    "--fmad=false",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the log
)


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librsoccer_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Start every command at once; wait for all.  Returns [(cmd, rc, log)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    return [(cmd, rc, out) for cmd, out, rc in outs]


def build() -> tuple[Path, str, float]:
    """Compile the library if it is not built yet.

    Returns ``(path, nvcc_log, seconds)``; seconds is 0 when the library
    was already there.
    """
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = nvcc_path()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(cu, objs)])
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    log = "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, _, out in results)
    failed = [(cmd, rc) for cmd, rc, _ in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0][1]}): {' '.join(failed[0][0])}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib, log, seconds


def check_operand(t, name: str, rows, batch: int, device, dtype=None):
    """Raise unless ``t`` is a contiguous ``(rows, batch)`` tensor (``rows``
    an int, or a tuple of leading dims) of ``dtype`` (default float32) on
    ``device`` — what a kernel takes."""
    dtype = dtype or torch.float32
    want = (*rows, batch) if isinstance(rows, tuple) else (rows, batch)
    if t.device != device or t.dtype != dtype or tuple(t.shape) != want \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {want} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
            + ("" if t.is_contiguous() else " (not contiguous)")
        )


def check_key(key, device):
    """Raise unless ``key`` is an int64 Philox key ``[k0, k1, step]`` on
    ``device``."""
    if key.device != device or key.dtype != torch.int64 or tuple(key.shape) != (3,):
        raise ValueError(f"key: want int64 (3,) on {device}, got {key.dtype} "
                         f"{tuple(key.shape)} on {key.device}")


def check_env_base(env_base: int, batch: int):
    """Raise unless the global env indices ``[env_base, env_base + batch)``
    fit the Philox counter's 32-bit env word (and the C entries' int)."""
    if not 0 <= env_base <= 0x7FFFFFFF - batch:
        raise ValueError(f"env_base {env_base} with {batch} envs leaves the 31-bit env range")


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C entry's
    ``argtypes``/``restype`` declared: the set-up phase
    ``rsoccer.setup.library`` (``utils/tracing``), which counts the builds
    (0 where the library was there) and nvcc's seconds."""
    with tracing.phase(tracing.SETUP_LIBRARY):
        path, _, seconds = build()
        tracing.add(tracing.SETUP_LIBRARY, "builds", int(seconds > 0))
        tracing.add(tracing.SETUP_LIBRARY, "build_s", seconds)
        return _declare(ctypes.CDLL(str(path)))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Every C entry's ``argtypes``/``restype`` on ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vss_params_fields.argtypes = []
    lib.vss_params_fields.restype = ctypes.c_char_p
    lib.kernels_abi_version.argtypes = []
    lib.kernels_abi_version.restype = i
    # n_blue, n_yellow, emit_final, rng_kernel, exact_trig, params*, st,
    # act, ou, sp, th, key, st_out, obs_out, aux_out, env_base, B, stream
    lib.vss_full_step.argtypes = [i] * 5 + [p] * 10 + [i, i, p]
    lib.vss_full_step.restype = i
    for name in ("vss_full_step_one_thread", "vss_full_step_one_thread_capped"):
        getattr(lib, name).argtypes = lib.vss_full_step.argtypes
        getattr(lib, name).restype = i
    # key, out, n_blk, env_base, B, stream
    lib.philox_words.argtypes = [p, p, i, i, i, p]
    lib.philox_words.restype = i
    lib.ssl_params_fields.argtypes = []
    lib.ssl_params_fields.restype = ctypes.c_char_p
    # emit_final, rng_kernel, params*, st, act, ball_u, spawn_u, theta_u,
    # key, st_out, obs_out, aux_out, env_base, B, stream
    lib.ssl_sd_full_step.argtypes = [i, i] + [p] * 10 + [i, i, p]
    lib.ssl_sd_full_step.restype = i
    lib.ssl_sd_full_step_one_thread.argtypes = lib.ssl_sd_full_step.argtypes
    lib.ssl_sd_full_step_one_thread.restype = i
    # emit_final, rng_kernel, params*, st, act, enemy_u, key, st_out,
    # obs_out, aux_out, env_base, B, stream
    lib.ssl_cp_full_step.argtypes = [i, i] + [p] * 8 + [i, i, p]
    lib.ssl_cp_full_step.restype = i
    # emit_final, rng_kernel, params*, st, act, st_out, obs_out, aux_out,
    # B, stream
    lib.ssl_dr_full_step.argtypes = [i, i] + [p] * 6 + [i, p]
    lib.ssl_dr_full_step.restype = i
    lib.ssl_dr_full_step_one_thread.argtypes = lib.ssl_dr_full_step.argtypes
    lib.ssl_dr_full_step_one_thread.restype = i
    # emit_final, rng_kernel, params*, st, act, ball_u, recv_u, key, st_out,
    # obs_out, aux_out, env_base, B, stream
    lib.ssl_pe_full_step.argtypes = [i, i] + [p] * 9 + [i, i, p]
    lib.ssl_pe_full_step.restype = i
    lib.vss_physics_params_fields.argtypes = []
    lib.vss_physics_params_fields.restype = ctypes.c_char_p
    # params*, robots, ball, cmd, robots_out, ball_out, n_robots, B, stream
    lib.vss_physics_step.argtypes = [p] * 6 + [i, i, p]
    lib.vss_physics_step.restype = i
    for name in ("vss_physics_step_one_thread", "vss_physics_step_one_thread_capped"):
        getattr(lib, name).argtypes = lib.vss_physics_step.argtypes
        getattr(lib, name).restype = i
    # reward, term, trunc, ep_ret, ep_len, ep_ret_out, ep_len_out, acc,
    # accumulate, B, stream
    lib.rollout_epilogue.argtypes = [p] * 8 + [i, i, p]
    lib.rollout_epilogue.restype = i
    # acc, B, sums_out, episodes_out, stream
    lib.rollout_epilogue_finish.argtypes = [p, i, p, p, p]
    lib.rollout_epilogue_finish.restype = i
    return lib
