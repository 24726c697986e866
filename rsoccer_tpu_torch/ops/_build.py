"""Build and load the port's CUDA kernels.

nvcc compiles every ``csrc/*.cu`` into ONE shared library with a plain C
interface, which ctypes loads.  The library goes to
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # keep each multiply and add rounded as the plain version's separate
    # ops are (see csrc/vss_full.cu); no --use_fast_math
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
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
        )
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib, log, seconds


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C entry's
    ``argtypes``/``restype`` declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vss_params_fields.argtypes = []
    lib.vss_params_fields.restype = ctypes.c_char_p
    # n_blue, n_yellow, emit_final, rng_kernel, params*, st, act, ou, sp,
    # th, key, st_out, obs_out, aux_out, B, stream
    lib.vss_full_step.argtypes = [i, i, i, i] + [p] * 10 + [i, p]
    lib.vss_full_step.restype = i
    # key, out, n_blk, B, stream
    lib.philox_words.argtypes = [p, p, i, i, p]
    lib.philox_words.restype = i
    return lib
