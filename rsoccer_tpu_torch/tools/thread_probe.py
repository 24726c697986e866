"""Probe the one-thread VSS kernels on the card: K1's ``vss_thread_kernel``
and K2's ``vss_physics_thread_kernel``.

    python -m rsoccer_tpu_torch.tools.thread_probe [--csrc DIR] [--ref DIR] [--out DIR] \\
        [--parts sass,sweep,stamps,substeps,sincos,bits]

Each part builds scratch copies of DIR's ``vss_full.cu`` and
``vss_physics.cu`` (default: this tree's ``csrc``) under ``--out`` with
the port's nvcc flags, and calls their one-thread C entries through ctypes
on the state after 20 VSS-v0 steps:

- ``sass``: ``cuobjdump -sass`` of the unpatched build; per kernel the
  warp instructions of one thread (one env) by class, inside and outside
  the substep loop (the widest backward branch), and the issue floor at
  131072 envs: (outside + 5 x inside) x warps / (132 SMs x 4 schedulers x
  the SM clock), the clock from ``nvidia-smi`` (``clocks.max.sm``).  The
  count is static: it includes the code of branches that a step may not
  take (the reset, the other trig policy, the slow paths of a division).
- ``sweep``: the kernels rebuilt with ``__launch_bounds__(block, min
  blocks)`` for each pair of ``SWEEP``, each timed in turns against the
  unpatched build (unpatched, variant, variant, unpatched; CUDA events)
  at 32768 and 131072 envs (1v0 at 8192), with its registers, spills and
  resident warps per SM.
- ``stamps``: a build with ``clock64()`` stamps at the phase boundaries
  (K1: load, draw, OU and wheels, substeps, outcome, final obs and reset,
  store; K2: load and trig, substeps, store), summed over the warps by
  lane 0 of each, at 8192 and 131072 envs.  A stamp reads the clock after
  the values of the phase before were used (an add chain over the loaded
  values ends the load phase), but the compiler may still hoist a load
  of a later phase.
- ``substeps``: the kernels rebuilt with 0 and 10 substeps instead of 5,
  timed in turns against the unpatched build: the time per substep and
  the time outside the substeps at the card's full occupancy.
- ``sincos``: ``sincosf`` against ``sinf`` and ``cosf`` over every one of
  the 2^32 f32 bit patterns, bit for bit (the same flags).
- with ``--ref DIR`` (another tree's ``csrc``, e.g. the parent commit's):
  ``bits``, the one-thread entries (and the capped variants) bit for bit
  against DIR's (both RNG modes, both obs variants, ``env_base`` 0 and
  4096, at the cases' batches and 8191), and always the turns DIR,
  this, (capped, capped,) this, DIR.

Device times come from ``tools/_trace.profile`` (CUDA events around a
CUDA graph of the launches where the profiler saw none).

Writes ``<out>/thread_probe.json`` and prints one JSON line per part, each
beside the card's name and power limit.  Needs a card and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SMS, SCHEDULERS = 132, 4
SUBSTEPS = 5
# (threads per block, min blocks per SM) of the sweep; 0: no minimum
SWEEP = ((64, 0), (64, 6), (64, 8), (64, 10), (64, 12), (128, 5), (128, 6), (256, 2), (256, 3))
# (name, kernel, team kwargs, batches)
CASES = (
    ("k1_3v3", "full", dict(), (32768, 65536, 131072)),
    ("k1_5v5", "full", dict(field_type=1, n_robots_blue=5, n_robots_yellow=5), (32768, 49152, 65536, 131072)),
    ("k1_1v0", "full", dict(n_robots_blue=1, n_robots_yellow=0), (8192, 32768, 131072)),
    ("k1_2v2", "full", dict(n_robots_blue=2, n_robots_yellow=2), (8192, 131072)),
    ("k1_4v4", "full", dict(field_type=1, n_robots_blue=4, n_robots_yellow=4), (8192, 32768, 131072)),
    ("k2_n6", "physics", dict(), (32768, 65536, 131072)),
    ("k2_n10", "physics", dict(field_type=1, n_robots_blue=5, n_robots_yellow=5), (32768, 49152, 65536, 131072)),
    ("k2_n1", "physics", dict(n_robots_blue=1, n_robots_yellow=0), (8192, 131072)),
)
STAMP_BATCHES = (8192, 131072)
TIMED = 200
SASS_CLASSES = (  # opcode patterns, each with any modifiers
    ("fp32", r"F(ADD|MUL|FMA|MNMX|SEL|SET|SETP|CHK|RND|SWZADD)(\..*)?"),
    ("mufu", r"MUFU(\..*)?"),
    ("int_mul", r"IMAD(\.WIDE|\.HI)?(\.U32)?|IMUL(\..*)?"),
    ("branch", r"(BRA|BSSY|BSYNC|CALL|RET|EXIT|BREAK|WARPSYNC|BMOV|JMP)(\..*)?"),
    ("global", r"(LDG|STG|RED|ATOM)(\..*)?"),
    ("local", r"(LDL|STL)(\..*)?"),
    ("shared", r"(LDS|STS|LDSM)(\..*)?"),
)
K1_KERNEL, K2_KERNEL = "vss_thread_kernel", "vss_physics_thread_kernel"


# ---------------------------------------------------------------- SASS
def sass_functions(lib_path) -> dict:
    """``cuobjdump -sass`` of ``lib_path``: {mangled name: [(address,
    opcode, branch target or None)]}, NOPs left out."""
    from rsoccer_tpu_torch.ops import _build

    tool = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = ins.search(line)
        if cur is None or not m or m.group(2) == "NOP":
            continue
        tgt = re.search(r"0x([0-9a-f]+)", m.group(3)) if m.group(2).startswith("BRA") else None
        cur.append((int(m.group(1), 16), m.group(2), int(tgt.group(1), 16) if tgt else None, m.group(3).strip()))
    return funcs


def classify(op: str) -> str:
    for name, pat in SASS_CLASSES:
        if re.fullmatch(pat, op):
            return name
    return "other"


def substep_loop(instrs, substeps: int = SUBSTEPS):
    """The (first, last) address of the substep loop: the backward branch
    whose last few instructions compare a counter with ``substeps`` (the
    loop's trip count), else the widest backward branch; (1, 0): none."""
    back = [(i, addr - tgt, tgt, addr) for i, (addr, _, tgt, _) in enumerate(instrs) if tgt is not None and tgt < addr]

    def counts(i):  # a compare with the trip count among the few instructions since the last branch
        for _, op, tgt, operands in reversed(instrs[max(0, i - 4):i]):
            if op.startswith("BRA"):
                return False
            if op.startswith("ISETP") and re.search(rf"\b0x{substeps:x}\b", operands):
                return True
        return False

    counted = [b for b in back if counts(b[0])]
    if not back:
        return 1, 0
    _, _, lo, hi = max(counted or back, key=lambda b: b[1])
    return lo, hi


def sass_profile(instrs, substeps: int = SUBSTEPS) -> dict:
    """One kernel's static SASS: counts by class inside and outside the
    substep loop (:func:`substep_loop`), and the per-env estimate outside
    + substeps x inside."""
    lo, hi = substep_loop(instrs, substeps)
    out = {"inside": {}, "outside": {}}
    for addr, op, _, _ in instrs:
        side = out["inside" if lo <= addr <= hi else "outside"]
        c = classify(op)
        side[c] = side.get(c, 0) + 1
    n_in, n_out = sum(out["inside"].values()), sum(out["outside"].values())
    return {**out, "n_inside": n_in, "n_outside": n_out, "per_env": n_out + substeps * n_in}


def kernel_label(mangled: str):
    """``name<template args>`` of a one-thread VSS kernel's mangled name,
    or None for another function."""
    for name in (K1_KERNEL, K2_KERNEL):
        m = re.search(rf"\d+({name}(_capped|_bounded)?)I(.*?)EEv", mangled)
        if m:
            args = [a or ("true" if b == "1" else "false") for a, b in re.findall(r"Li(\d+)E|Lb(\d)E", m.group(3) + "E")]
            return f"{m.group(1)}<{','.join(args)}>"
    return None


def label_of_demangled(name: str):
    """The :func:`kernel_label` of a kernel as the profiler names it
    (``void (anonymous namespace)::vss_thread_kernel_bounded<6, true, 8>(...``),
    or None."""
    m = re.search(r"(vss_(?:physics_)?thread_kernel(?:_capped|_bounded)?)<([^>]*)>", name)
    return f"{m.group(1)}<{m.group(2).replace(' ', '')}>" if m else None


def kernel_sass(lib_path, dump=None) -> dict:
    """{kernel label: sass_profile} of the one-thread VSS kernels in
    ``lib_path``; with ``dump`` (a directory), each kernel's instructions
    go to ``dump/<label>.sass``, the substep loop's marked."""
    res = {}
    for mangled, instrs in sass_functions(lib_path).items():
        lab = kernel_label(mangled)
        if lab:
            res[lab] = sass_profile(instrs)
            if dump is not None:
                lo, hi = substep_loop(instrs)
                Path(dump, re.sub(r"[<>,]", "_", lab) + ".sass").write_text("".join(
                    f"{'L' if lo <= a <= hi else ' '} {a:05x} {op} {operands}\n" for a, op, _, operands in instrs))
    return res


def issue_floor_us(per_env: int, batch: int, clock_mhz: float) -> float:
    """Warp instructions of ``batch`` envs (one env per thread, 32 per
    warp) over the card's issue rate: 132 SMs x 4 schedulers x clock."""
    return per_env * (batch / 32) / (SMS * SCHEDULERS * clock_mhz)


def sm_clocks() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    sm, mx = (float(x) for x in out[0].split(","))
    return {"clocks_sm_mhz": sm, "clocks_max_sm_mhz": mx}


# ---------------------------------------------------------------- ptxas
def ptxas_kernels(log: str) -> dict:
    """``-Xptxas -v`` output -> {mangled: {"registers", "spill_stores",
    "spill_loads", "stack"}}."""
    res, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = res.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return res


SM_SMEM_BYTES, BLOCK_SMEM_RESERVED = 233472, 1024  # H100: 228 KB per SM, 1 KB of it reserved per block


def warps_per_sm(registers: int, block: int, smem: int = 0) -> int:
    """Resident warps per SM of a kernel by its registers (each of the 4
    schedulers' 16384 registers, allocated per warp in units of 256), its
    block size and its static shared memory per block: at most 64 warps
    and 32 blocks."""
    per_warp = -(-registers * 32 // 256) * 256
    wpb = block // 32
    blocks = min(SCHEDULERS * (16384 // per_warp) // wpb, 64 // wpb, 32,
                 SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVED) if smem else 32)
    return blocks * wpb


def thread_kernel_regs(ptx: dict) -> dict:
    """{kernel label: registers, spill bytes} of the one-thread kernels in
    a ptxas parse."""
    return {kernel_label(m): {"registers": v.get("registers"), "smem": v.get("smem", 0),
                              "spill_bytes": v.get("spill_stores", 0) + v.get("spill_loads", 0)}
            for m, v in ptx.items() if kernel_label(m)}


# ---------------------------------------------------------------- scratch builds
def _patch(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) < count:
        raise RuntimeError(f"probe patch: {old!r} not found {count} time(s)")
    return src.replace(old, new)


def bounds_patch(block: int, min_blocks: int):
    """The (uncapped) one-thread kernels at ``block`` threads per block and
    ``__launch_bounds__(block, min_blocks)`` (0: no minimum)."""
    def f(name, src):
        if "kThreadBlock = 64;" not in src:  # no one-thread kernel in this file
            return src
        src = _patch(src, "kThreadBlock = 64;", f"kThreadBlock = {block};")
        bounds = f"__launch_bounds__(kThreadBlock, {min_blocks})" if min_blocks else "__launch_bounds__(kThreadBlock)"
        src, n = re.subn(r"__launch_bounds__\(kThreadBlock\)(?=\n    vss_(physics_)?thread_kernel\()", bounds, src)
        if n != 1:
            raise RuntimeError(f"probe patch: {n} launch bounds of the one-thread kernel in {name}")
        return src
    return f


def substeps_patch(n: int):
    return lambda name, src: src.replace("constexpr int kSubsteps = 5;", f"constexpr int kSubsteps = {n};")


PROBE_HEAD = r"""
__device__ unsigned long long g_probe[16];
static __device__ __forceinline__ long long probe_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
static __device__ __forceinline__ float probe_add(float a, float b) {
  float o;
  asm volatile("add.f32 %0, %1, %2;" : "=f"(o) : "f"(a), "f"(b));
  return o;
}
template <int NT>
static __device__ __forceinline__ void probe_flush(const long long (&t)[NT], float acc) {
  if ((threadIdx.x & 31) == 0) {
    for (int i = 0; i + 1 < NT; ++i) atomicAdd(&g_probe[i], (unsigned long long)(t[i + 1] - t[i]));
    atomicAdd(&g_probe[15], 1ull);
  }
  if (__float_as_uint(acc) == 0x7fc00001u) atomicAdd(&g_probe[14], 1ull);
}
extern "C" int probe_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
"""

# (anchor in the one-thread kernel, text put before it): the kernel before
# its redesign, which loaded every state row first and drew the whole noise
# tail
K1_STAMPS_FIRST = (
    ("  // ---- noise: the OU normals", """  {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      _acc = probe_add(_acc, r[q].x); _acc = probe_add(_acc, r[q].y); _acc = probe_add(_acc, r[q].th);
      _acc = probe_add(_acc, r[q].vx); _acc = probe_add(_acc, r[q].vy); _acc = probe_add(_acc, r[q].w);
      _acc = probe_add(_acc, ou[q]); _acc = probe_add(_acc, ou[N + q]);
    }
    _acc = probe_add(_acc, ball.x); _acc = probe_add(_acc, ball.vz); _acc = probe_add(_acc, steps);
    _acc = probe_add(_acc, has_pot); _acc = probe_add(_acc, shaping[5]);
  }
  _t[1] = probe_clock();
"""),
    ("  // ---- OU update (envs/ou.ou_update", "  _acc = probe_add(_acc, ou_n[2 * N - 1]);\n  _t[2] = probe_clock();\n"),
    ("  // ---- physics substeps; cos/sin", "  _acc = probe_add(_acc, r[N - 1].w_tgt);\n  _t[3] = probe_clock();\n"),
    ("  // ---- reward & termination cascade", "  _acc = probe_add(_acc, ball.x);\n  _t[4] = probe_clock();\n"),
    ("  auto npos = [&]", "  _acc = probe_add(_acc, out.reward);\n  _t[5] = probe_clock();\n"),
    ("  // ---- outputs\n", "  _acc = probe_add(_acc, ball.x);\n  _t[6] = probe_clock();\n"),
)
# the kernel since its redesign: the state and OU rows first (the cold rows on
# their way to shared memory), the OU slots' draw, the OU rows and the
# targets, the cold rows read after the substeps
K1_STAMPS = (
    ("  // ---- OU update (envs/ou.ou_update: mu = 0, sigma = 0.5): the normals", """  {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      _acc = probe_add(_acc, r[q].x); _acc = probe_add(_acc, r[q].y); _acc = probe_add(_acc, r[q].th);
      _acc = probe_add(_acc, r[q].vx); _acc = probe_add(_acc, r[q].vy); _acc = probe_add(_acc, r[q].w);
      _acc = probe_add(_acc, ou[q]); _acc = probe_add(_acc, ou[N + q]);
    }
    _acc = probe_add(_acc, ball.x); _acc = probe_add(_acc, ball.vz);
  }
  _t[1] = probe_clock();
"""),
    ("#pragma unroll\n    for (int q = 0; q < N; ++q) {\n#pragma unroll\n      for (int w = 0; w < 2; ++w) {\n        float n;",
     "    if constexpr (RNG_KERNEL) _acc = probe_add(_acc, tail[4 * N - 1]);\n    _t[2] = probe_clock();\n"),
    ("  // ---- physics substeps; cos/sin", "  _t[3] = probe_clock();\n"),
    ("  // ---- reward & termination cascade", "  _acc = probe_add(_acc, ball.x);\n  _t[4] = probe_clock();\n"),
    ("  auto npos = [&]", "  _acc = probe_add(_acc, out.reward);\n  _t[5] = probe_clock();\n"),
    ("  // ---- outputs\n", "  _acc = probe_add(_acc, ball.x);\n  _t[6] = probe_clock();\n"),
)
K1_PHASES = ("load", "draw", "ou_wheels", "substeps", "outcome", "final_obs_reset", "store")
K2_PHASES = ("load_trig", "substeps", "store")
LD_DEF = "#define LD(ptr, row) ((ptr)[(size_t)(row) * (size_t)B + b])\n"


def k1_thread_file(src: str) -> bool:
    """Whether the source holds K1's one-thread step (vss_full.cu before its
    redesign, vss_thread.cuh since)."""
    return "one thread per env" in src and LD_DEF in src


def stamps_patch(name, src):
    """The stamps build: K1's counters ``g_probe`` read by ``probe_read``,
    K2's ``g_probe_phys`` by ``probe_read_phys``."""
    k1 = k1_thread_file(src)
    if not k1 and name != "vss_physics.cu":
        return src
    head = PROBE_HEAD if k1 else PROBE_HEAD.replace("g_probe", "g_probe_phys").replace("probe_read", "probe_read_phys")
    inc = next(i for i in ('#include "vss_world.cuh"\n', '#include "vss_step.cuh"\n') if i in src)
    src = _patch(src, inc, inc + head)
    n = len(K1_PHASES) + 1 if k1 else len(K2_PHASES) + 1
    m = re.search("one thread per env" if k1 else
                  r"template <[^>]*>\n__global__ void __launch_bounds__\(kThreadBlock\)\n    vss_physics_thread_kernel|"
                  r"// one env's physics step on this thread", src)
    if not m:
        raise RuntimeError(f"probe patch: no one-thread kernel in {name}")
    head, sep, tail = src[:m.start()], "", src[m.start():]
    tail = _patch(tail, LD_DEF, LD_DEF + f"  long long _t[{n}];\n  float _acc = 0.0f;\n  _t[0] = probe_clock();\n")
    if k1:
        for anchor, text in K1_STAMPS if K1_STAMPS[0][0] in tail else K1_STAMPS_FIRST:
            tail = _patch(tail, anchor, text + anchor)
    else:
        tail = _patch(tail, "#pragma unroll 1  // kept rolled", """  {
#pragma unroll
    for (int q = 0; q < N; ++q) { _acc = probe_add(_acc, r[q].s); _acc = probe_add(_acc, r[q].x); }
    _acc = probe_add(_acc, ball.vz);
  }
  _t[1] = probe_clock();
#pragma unroll 1  // kept rolled""")
        tail = _patch(tail, "#pragma unroll\n  for (int q = 0; q < N; ++q) {\n    LD(rb_out",
                      "  _acc = probe_add(_acc, ball.x);\n  _t[2] = probe_clock();\n"
                      "#pragma unroll\n  for (int q = 0; q < N; ++q) {\n    LD(rb_out")
    tail = _patch(tail, "#undef LD\n}", f"  _t[{n - 1}] = probe_clock();\n  probe_flush(_t, _acc);\n#undef LD\n}}")
    return head + sep + tail


SINCOS_SRC = r"""
#include <cuda_runtime.h>
__device__ __noinline__ float probe_sin(float x) { return sinf(x); }
__device__ __noinline__ float probe_cos(float x) { return cosf(x); }
__global__ void sincos_kernel(unsigned long long* bad, unsigned* first) {
  const unsigned long long n = 1ull << 32, stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x; i < n; i += stride) {
    const float x = __uint_as_float((unsigned)i);
    float s, c;
    sincosf(x, &s, &c);
    if (__float_as_uint(s) != __float_as_uint(probe_sin(x)) || __float_as_uint(c) != __float_as_uint(probe_cos(x)))
      if (atomicAdd(bad, 1ull) == 0) *first = (unsigned)i;
  }
}
extern "C" int sincos_check(unsigned long long* bad, unsigned* first) {
  sincos_kernel<<<132 * 16, 256>>>(bad, first);
  return (int)cudaGetLastError();
}
"""


# the VSS sources a scratch build compiles (those of them a tree has: the
# one-thread files since the redesign) and the headers its patches may change
VSS_SOURCES = ("vss_full.cu", "vss_thread.cu", "vss_thread_capped.cu", "vss_physics.cu")
VSS_HEADERS = ("vss_step.cuh", "vss_thread.cuh")


def build_variant(csrc, work: Path, tag: str, patch=None, sources=VSS_SOURCES):
    """Copy ``csrc`` to ``work/tag``, apply ``patch(name, text)`` to each of
    ``sources`` that it holds, nvcc them with the port's flags into
    ``lib.so``.  Returns (ctypes library, ptxas parse, library path)."""
    from rsoccer_tpu_torch.ops import _build

    d = work / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    sources = [n for n in sources if (d / n).exists()]
    for name in sources + [h for h in VSS_HEADERS if (d / h).exists()]:
        if patch is not None:
            (d / name).write_text(patch(name, (d / name).read_text()))
    nvcc = _build.nvcc_path()
    logs = []
    for name in sources:
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(d / f"{name}.o"), str(d / name)],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc {tag}/{name} failed:\n{r.stdout}{r.stderr}")
        logs.append(r.stdout + r.stderr)
    subprocess.run([nvcc, "-shared", "-o", str(d / "lib.so"), *(str(d / f"{n}.o") for n in sources)], check=True)
    lib = ctypes.CDLL(str(d / "lib.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    if "vss_physics.cu" in sources:
        for suffix in ("", "_capped") if hasattr(lib, "vss_full_step_one_thread_capped") else ("",):
            getattr(lib, "vss_full_step_one_thread" + suffix).argtypes = [i] * 5 + [p] * 10 + [i, i, p]
            getattr(lib, "vss_physics_step_one_thread" + suffix).argtypes = [p] * 6 + [i, i, p]
    return lib, ptxas_kernels("".join(logs)), d / "lib.so"


# ---------------------------------------------------------------- operands and calls
def operands(kind: str, batch: int, kw: dict):
    """VSS-v0 (``kw``) after 20 main-path steps at ``batch`` envs.  Returns
    ``call(lib, rng=1, emit_final=0, env_base=0, capped=False)``, which
    makes the launch of ``lib``'s one-thread entry (its ``_capped`` variant)
    on these operands (a function returning the C entry's error code), and
    ``outs(emit_final)``, its outputs."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp
    from rsoccer_tpu_torch.ops.philox import make_key

    benv = rt.make_vec("VSS-v0", batch, device="cuda", fused=True, fused_rng="kernel", **kw)
    env = benv.env
    carry, _ = R.make_rollout_fn(benv, 20)(R.init_carry(benv, seed=0))
    st = carry.state
    gen = torch.Generator(device="cuda").manual_seed(7)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if kind == "full":
        act = torch.rand((2, batch), generator=gen, device="cuda") * 2 - 1
        key = make_key(3, device="cuda")
        rows = {base: vf.draw_step_rows(env, key.clone(), batch, base) for base in (0, 4096)}
        o = {ef: (torch.empty_like(st), torch.empty((env.obs_size * (1 + ef), batch), device="cuda"),
                  torch.empty((vf.N_AUX, batch), device="cuda")) for ef in (0, 1)}
        params = vf._params_struct(env)
        trig = int(not vf.taylor_rotation_holds(env))

        def call(lib, rng=1, emit_final=0, env_base=0, capped=False):
            ou, sp, th = (None, None, None) if rng else (t.data_ptr() for t in rows[env_base])
            entry = getattr(lib, "vss_full_step_one_thread" + ("_capped" if capped else ""))
            return lambda: entry(
                env.n_blue, env.n_yellow, emit_final, rng, trig, ctypes.byref(params), st.data_ptr(),
                act.data_ptr(), ou, sp, th, key.data_ptr() if rng else None,
                *(t.data_ptr() for t in o[emit_final]), env_base, batch, stream())
        return call, lambda emit_final=0: o[emit_final]
    rb, bl = vp._stack(vf.unpack_vss_state(st, env.n_robots, env.field.rbt_wheel_radius).world)
    cmd = (torch.rand((2, env.n_robots, batch), generator=gen, device="cuda") * 2 - 1) * 60.0
    o = (torch.empty_like(rb), torch.empty_like(bl))
    params = vp._params_struct(env)

    def call(lib, rng=1, emit_final=0, env_base=0, capped=False):
        entry = getattr(lib, "vss_physics_step_one_thread" + ("_capped" if capped else ""))
        return lambda: entry(
            ctypes.byref(params), rb.data_ptr(), bl.data_ptr(), cmd.data_ptr(), *(t.data_ptr() for t in o),
            env.n_robots, batch, stream())
    return call, lambda emit_final=0: o


def time_us(fn, n: int = TIMED) -> float:
    """Device µs per launch of the one-thread kernels over ``n`` launches
    (``tools/_trace.profile``); where the profiler saw none of them, CUDA
    events around the replay of a CUDA graph of ``n`` launches."""
    from rsoccer_tpu_torch.tools import _trace

    if fn():
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    kernels = _trace.profile(fn, n, None, "cuda", match=r"thread_kernel").kernels
    hits = [v for k, v in kernels.items() if re.search(r"thread_kernel", k)]
    if hits:
        return sum(us for us, _ in hits) / sum(c for _, c in hits)
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n * 1e3


def turns(base, var) -> dict:
    t = [time_us(f) for f in (base, var, var, base)]
    return {"turns_us": t, "base_us": (t[0] + t[3]) / 2, "variant_us": (t[1] + t[2]) / 2}


def label(name: str) -> str:
    n = {"k1_3v3": 6, "k1_5v5": 10, "k1_1v0": 1, "k1_2v2": 4, "k1_4v4": 8, "k2_n6": 6, "k2_n10": 10,
         "k2_n1": 1}[name.split("@")[0].removesuffix("_rows")]
    return f"{K1_KERNEL}<{n},true>" if name.startswith("k1") else f"{K2_KERNEL}<{n}>"


def shown(lab: str) -> bool:
    """The kernels a part prints: kernel RNG (K1), 1, 6 and 10 robots."""
    return re.search(r"<(1|6|10)(,true)?[,>]", lab) is not None


def has_capped(name: str) -> bool:
    """Whether the case's robot count (8 or 10 here) has a capped variant."""
    return "5v5" in name or "4v4" in name or "n10" in name


def bit_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


BITS_CASES = CASES + (
    ("k1_3v3_dt0.1", "full", dict(time_step=0.1), (8191,)),
    ("k1_5v5_dt0.1", "full", dict(field_type=1, n_robots_blue=5, n_robots_yellow=5, time_step=0.1), (8191,)),
    ("k1_2v2", "full", dict(n_robots_blue=2, n_robots_yellow=2), (8191,)),
)


def check_bits(base_lib, ref_lib) -> int:
    """The base build's one-thread entries against the reference build's,
    every output bit for bit: K1 in both RNG modes, both obs variants and
    env_base 0 and 4096, K2; at each case's batches and at 8191.  Returns
    the number of comparisons; raises on a difference."""
    n = 0
    for name, kind, kw, batches in BITS_CASES:
        for batch in sorted(set(batches) | {8191}):
            call, outs = operands(kind, batch, kw)
            modes = [(rng, ef, eb) for rng in (0, 1) for ef in (0, 1) for eb in (0, 4096)] if kind == "full" else [
                (1, 0, 0)]
            runs = [(ref_lib, False), (base_lib, False)] + ([(base_lib, True)] if has_capped(name) else [])
            for rng, ef, eb in modes:
                got = []
                for lib, capped in runs:
                    for t in outs(ef):
                        t.fill_(float("nan"))
                    if call(lib, rng, ef, eb, capped)():
                        raise RuntimeError(f"{name} launch failed")
                    torch.cuda.synchronize()
                    got.append(tuple(t.clone() for t in outs(ef)))
                if not all(bit_equal(got[0], g) for g in got[1:]):
                    raise AssertionError(f"{name} at {batch} envs (rng={rng}, final={ef}, env_base={eb}): "
                                         "outputs differ from the reference build's")
                n += len(got) - 1
    return n


# ---------------------------------------------------------------- parts
def run(csrc, out: Path, parts, card: str, ref=None) -> dict:
    import tempfile

    out.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="thread_probe_"))
    res = {"card": card, "csrc": str(csrc), "ref": str(ref) if ref else None}
    builds = {"base": (csrc, None)}
    if ref:
        builds["ref"] = (ref, None)
    if "sweep" in parts:
        builds.update({f"bounds_{b}_{m}": (csrc, bounds_patch(b, m)) for b, m in SWEEP})
    if "stamps" in parts:  # without the capped file, which would define the header's probe symbols again
        builds["stamps"] = (csrc, stamps_patch, tuple(n for n in VSS_SOURCES if n != "vss_thread_capped.cu"))
    if "substeps" in parts:
        builds.update({f"substeps_{n}": (csrc, substeps_patch(n)) for n in (0, 10)})
    if "sincos" in parts:
        sc = work / "sincos_src"
        sc.mkdir()
        (sc / "sincos.cu").write_text(SINCOS_SRC)
    with ThreadPoolExecutor(max_workers=8) as pool:
        futs = {tag: pool.submit(build_variant, d, work, tag, *rest) for tag, (d, *rest) in builds.items()}
        if "sincos" in parts:
            futs["sincos"] = pool.submit(build_variant, sc, work, "sincos", None, ("sincos.cu",))
        libs, res["build_errors"] = {}, {}
        for tag, f in futs.items():
            try:
                libs[tag] = f.result()
            except RuntimeError as e:  # a variant that does not build is left out, and said so
                res["build_errors"][tag] = str(e)[-4000:]
                print(json.dumps({"part": "build_error", "variant": tag, "error": str(e)[-1500:]}), flush=True)
    base_lib = libs["base"][0]
    res["registers"] = {tag: thread_kernel_regs(ptx) for tag, (_, ptx, _) in libs.items() if tag != "sincos"}
    print(json.dumps({"part": "registers", "card": card, **{
        t: {k: [v["registers"], v["spill_bytes"]] for k, v in r.items() if shown(k)}
        for t, r in res["registers"].items()}}), flush=True)

    if "bits" in parts and "ref" in libs:
        res["bits"] = check_bits(base_lib, libs["ref"][0])
        print(json.dumps({"part": "bits", "card": card, "comparisons": res["bits"], "bit_equal": True}), flush=True)

    calls = {}
    for name, kind, kw, batches in CASES:
        for batch in batches:
            call = operands(kind, batch, kw)[0]
            calls[f"{name}@{batch}"] = call
            if kind == "full":  # and the input-rows variant
                calls[f"{name}_rows@{batch}"] = lambda lib, capped=False, c=call: c(lib, 0, capped=capped)
    if "sass" in parts:
        time_us(calls["k1_3v3@131072"](base_lib))  # warm clocks before reading them
        clocks = sm_clocks()
        res["sass"] = {"clocks": clocks}
        for tag in ("base", "ref"):
            if tag not in libs:
                continue
            prof = kernel_sass(libs[tag][2], dump=out if tag == "base" else None)
            keep = {k: v for k, v in prof.items() if shown(k)}
            res["sass"][tag] = {"kernels": prof, "issue_floor_us_131072": {
                k: issue_floor_us(v["per_env"], 131072, clocks["clocks_max_sm_mhz"]) for k, v in prof.items()}}
            print(json.dumps({"part": f"sass_{tag}", "card": card, "clocks": clocks,
                              "kernels": {k: {"inside": v["inside"], "outside": v["outside"],
                                              "per_env": v["per_env"]} for k, v in keep.items()}}), flush=True)
    if "ref" in libs:  # the reference's one-thread kernel against this one's (and its capped variant)
        res["ref_turns"] = {}
        for name, call in calls.items():
            fns = [call(libs["ref"][0]), call(base_lib)] + ([call(base_lib, capped=True)] if has_capped(name) else [])
            order = fns + fns[:0:-1] + fns[:1]  # ref, base, [capped, capped,] base, ref
            t = [time_us(f) for f in order]
            k = len(fns)
            res["ref_turns"][name] = {"turns_us": t, "ref_us": (t[0] + t[-1]) / 2, "this_us": (t[1] + t[-2]) / 2,
                                      **({"capped_us": (t[2] + t[3]) / 2} if k == 3 else {})}
        print(json.dumps({"part": "ref_turns", "card": card, **{
            n: [round(v["ref_us"], 2), round(v["this_us"], 2)] + ([round(v["capped_us"], 2)] if "capped_us" in v
                                                                   else [])
            for n, v in res["ref_turns"].items()}}), flush=True)
    timed = [t for t in builds if t not in ("base", "stamps", "ref")]
    res["turns"] = {}
    for tag in timed:
        if tag not in libs:
            continue
        lib = libs[tag][0]
        row = {}
        for name, call in calls.items():
            capped = has_capped(name) and int(name.split("@")[1]) > 32768 and hasattr(lib, "vss_full_step_one_thread_capped")
            t = turns(call(base_lib, capped=capped), call(lib, capped=capped))
            r = res["registers"][tag].get(label(name), {})
            block = int(tag.split("_")[1]) if tag.startswith("bounds_") else 64
            t.update(r, warps_per_sm=warps_per_sm(r["registers"], block, r["smem"]) if r.get("registers") else None)
            row[name] = t
        res["turns"][tag] = row
        print(json.dumps({"part": f"turns_base_vs_{tag}", "card": card, **{
            k: [round(v["base_us"], 2), round(v["variant_us"], 2), v.get("registers"), v.get("spill_bytes"),
                v.get("warps_per_sm")] for k, v in row.items()}}), flush=True)
    if "stamps" in parts and "stamps" in libs:
        lib = libs["stamps"][0]
        buf = (ctypes.c_ulonglong * 16)()
        for f in (lib.probe_read, lib.probe_read_phys):
            f.argtypes = [ctypes.c_void_p]
            f(buf)
        res["stamps"] = {}
        for name, kind, kw, _ in CASES:
            for batch in STAMP_BATCHES:
                call = operands(kind, batch, kw)[0](lib)
                read = lib.probe_read if kind == "full" else lib.probe_read_phys
                call()
                read(buf)  # reset after a warm-up launch
                call()
                read(buf)
                warps = buf[15]
                phases = K1_PHASES if kind == "full" else K2_PHASES
                cyc = {ph: buf[i] / warps for i, ph in enumerate(phases)}
                res["stamps"][f"{name}@{batch}"] = {"warps": warps, "cycles_per_warp": cyc,
                                                    "total_cycles_per_warp": sum(cyc.values())}
        print(json.dumps({"part": "stamps", "card": card, **{
            k: {ph: round(c) for ph, c in v["cycles_per_warp"].items()} for k, v in res["stamps"].items()}}),
            flush=True)
    if "sincos" in parts and "sincos" in libs:
        lib = libs["sincos"][0]
        lib.sincos_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        first = torch.zeros(1, dtype=torch.int32, device="cuda")
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        err = lib.sincos_check(bad.data_ptr(), first.data_ptr())
        b.record()
        b.synchronize()
        res["sincos"] = {"patterns": 1 << 32, "mismatches": int(bad.item()), "err": err,
                         "first_mismatch_bits": hex(int(first.item()) & 0xFFFFFFFF) if bad.item() else None,
                         "ms": a.elapsed_time(b)}
        print(json.dumps({"part": "sincos", "card": card, **res["sincos"]}), flush=True)
    (out / "thread_probe.json").write_text(json.dumps(res, indent=1))
    shutil.rmtree(work, ignore_errors=True)
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--csrc", default=str(Path(__file__).resolve().parent.parent / "csrc"))
    p.add_argument("--ref", default=None, help="another tree's csrc: bit for bit and in turns against it")
    p.add_argument("--out", default="chiprun_out/thread_probe")
    p.add_argument("--parts", default="sass,sweep,stamps,substeps,sincos")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("thread_probe needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    return run(Path(args.csrc), Path(args.out), set(args.parts.split(",")), card, args.ref and Path(args.ref))


if __name__ == "__main__":
    main()
