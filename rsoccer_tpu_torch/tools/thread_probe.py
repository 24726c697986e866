"""Probe the one-thread kernels on the card: with ``--family vss`` (the
default) K1's ``vss_thread_kernel`` and K2's ``vss_physics_thread_kernel``,
with ``--family ssl`` K4's ``sd_thread_kernel`` and K6's
``dr_thread_kernel`` (and, in ``sass``, K5's ``cp_full_kernel`` and K7's
``pe_full_kernel``, which share their world step).

    python -m rsoccer_tpu_torch.tools.thread_probe [--family vss|ssl] [--csrc DIR] [--ref DIR] \\
        [--out DIR] [--parts sass,sweep,stamps,substeps,sincos,bits]

Each part builds scratch copies of DIR's family sources (default: this
tree's ``csrc``; VSS ``vss_full.cu``, ``vss_thread*.cu``,
``vss_physics.cu``; SSL ``ssl_full.cu`` and ``ssl_thread.cu``, those of
them the tree has) under ``--out`` with the port's nvcc flags, and calls
their one-thread C entries through ctypes on the state after 20 main-path
steps (VSS-v0; SSLStaticDefenders-v0 and SSLDribbling-v0 under uniform
random actions):

- ``sass``: ``cuobjdump -sass`` of the unpatched build; per kernel the
  warp instructions of one thread (one env) by class, inside and outside
  the substep loop (the widest backward branch), and the issue floor at
  32768 and 131072 envs: (outside + 5 x inside) x warps / (132 SMs x 4
  schedulers x the SM clock), the clock from ``nvidia-smi``
  (``clocks.max.sm``).  The count is static: it includes the code of
  branches that a step may not take (the reset, the other trig policy,
  the slow paths of a division, of fmodf and of the trig's range
  reduction).
- ``sweep``: the kernels rebuilt with ``__launch_bounds__(block, min
  blocks)`` for each pair of ``SWEEP``, each timed in turns against the
  unpatched build (unpatched, variant, variant, unpatched; CUDA events)
  at the cases' batches (VSS 32768-131072, 1v0 also at 8192; SSL
  10240-131072), with its registers, spills and resident warps per SM.
- ``stamps``: a build with ``clock64()`` stamps at the phase boundaries
  (K1: load, draw, OU and wheels, substeps, outcome, final obs and reset,
  store; K2: load and trig, substeps, store; K4 and K6: load, action and
  trig, substeps, outcome, final obs and stores, reset; the K4 and K6
  stamps fit ``ssl_thread.cu``'s layout only), summed over the warps by
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
  4096, at the cases' batches and 8191; SSL at 8191, 8449, 16385, 32768
  and 131072), and always the turns DIR, this, (capped, capped,) this,
  DIR.  The SSL operands also report the share of 32-env warps that hold
  a done env (``done_warp_share``).

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
SWEEP = ((64, 0), (64, 6), (64, 8), (64, 10), (64, 12), (128, 4), (128, 5), (128, 6), (256, 2), (256, 3))
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
# the SSL one-thread kernels (K4, K6), and the SSL kernels that share their
# world step (K5, K7), whose SASS a change to ssl_body.cuh moves too
K4_KERNEL, K6_KERNEL = "sd_thread_kernel", "dr_thread_kernel"
SSL_SASS_KERNELS = (K4_KERNEL, K6_KERNEL, "cp_full_kernel", "pe_full_kernel")
# (name, task, batches): K4 and K6 above their group crossover (8448 envs)
SSL_CASES = (
    ("k4_sd", "sd", (10240, 16384, 32768, 65536, 131072)),
    ("k6_dr", "dr", (10240, 16384, 32768, 65536, 131072)),
)
SSL_BITS_BATCHES = (8191, 8449, 16385, 32768, 131072)
SSL_ENV_IDS = {"sd": "SSLStaticDefenders-v0", "dr": "SSLDribbling-v0"}
SSL_ENTRIES = {"sd": "ssl_sd_full_step_one_thread", "dr": "ssl_dr_full_step_one_thread"}


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
    """``name<template args>`` of a one-thread kernel's mangled name (VSS,
    or an SSL kernel of ``SSL_SASS_KERNELS``), or None for another
    function."""
    for name in (K1_KERNEL, K2_KERNEL, *SSL_SASS_KERNELS):
        m = re.search(rf"\d+({name}(_capped|_bounded)?)I(.*?)EEv", mangled)
        if m:
            args = [a or ("true" if b == "1" else "false") for a, b in re.findall(r"Li(\d+)E|Lb(\d)E", m.group(3) + "E")]
            return f"{m.group(1)}<{','.join(args)}>"
    return None


def label_of_demangled(name: str):
    """The :func:`kernel_label` of a kernel as the profiler names it
    (``void (anonymous namespace)::vss_thread_kernel_bounded<6, true, 8>(...``),
    or None."""
    m = re.search(r"((?:vss_(?:physics_)?|sd_|dr_)thread_kernel(?:_capped|_bounded)?|(?:cp|pe)_full_kernel)<([^>]*)>",
                  name)
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
    ``__launch_bounds__(block, min_blocks)`` (0: no minimum): VSS's one
    kernel of a file, SSL's SD and DR kernels (whatever bound they had)."""
    def f(name, src):
        bounds = f"__launch_bounds__(kThreadBlock, {min_blocks})" if min_blocks else "__launch_bounds__(kThreadBlock)"
        if name.startswith("ssl_"):
            src, n = re.subn(r"__launch_bounds__\(kThreadBlock(?:, \w+)?\)(?=\n    (?:sd|dr)_thread_kernel\()",
                             bounds, src)
            if n == 0:  # no SD or DR one-thread kernel in this file
                return src
            src, m = re.subn(r"constexpr int kThreadBlock = \d+;", f"constexpr int kThreadBlock = {block};", src)
            if n != 2 or m != 1:
                raise RuntimeError(f"probe patch: {n} launch bounds of the SD and DR one-thread kernels, "
                                   f"{m} blocks in {name}")
            return src
        if "kThreadBlock = 64;" not in src:  # no one-thread kernel in this file
            return src
        src = _patch(src, "kThreadBlock = 64;", f"kThreadBlock = {block};")
        src, n = re.subn(r"__launch_bounds__\(kThreadBlock\)(?=\n    vss_(physics_)?thread_kernel\()", bounds, src)
        if n != 1:
            raise RuntimeError(f"probe patch: {n} launch bounds of the one-thread kernel in {name}")
        return src
    return f


def substeps_patch(n: int):
    """The world steps at ``n`` substeps instead of 5 (VSS's kSubsteps,
    SSL's kSslSubsteps)."""
    return lambda name, src: src.replace("constexpr int kSubsteps = 5;", f"constexpr int kSubsteps = {n};").replace(
        "constexpr int kSslSubsteps = 5;", f"constexpr int kSslSubsteps = {n};")


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


# the phases the stamps split a K4 or K6 step into: the stores (of every env
# but the done ones) precede the reset, which stores the done envs' rows
SSL_PHASES = ("load", "action_trig", "substeps", "outcome", "final_obs_store", "reset")
# (anchor in the kernel, text put before it): the phases between the comment
# lines that open them
SSL_STAMPS = (
    ("  // ---- action and trig", """  {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      _acc = probe_add(_acc, e.x[q]); _acc = probe_add(_acc, e.y[q]); _acc = probe_add(_acc, e.th[q]);
      _acc = probe_add(_acc, e.vx[q]); _acc = probe_add(_acc, e.vy[q]); _acc = probe_add(_acc, e.w[q]);
    }
    _acc = probe_add(_acc, e.bl.x); _acc = probe_add(_acc, e.bl.vz);
  }
  _t[1] = probe_clock();
"""),
    ("  // ---- substeps", "  _acc = probe_add(_acc, c[N - 1]);\n  _t[2] = probe_clock();\n"),
    ("  // ---- outcome", "  _acc = probe_add(_acc, e.bl.x);\n  _t[3] = probe_clock();\n"),
    ("  // ---- final obs and outputs", "  _acc = probe_add(_acc, reward);\n  _t[4] = probe_clock();\n"),
    ("  // ---- reset", "  _t[5] = probe_clock();\n"),
)
SSL_BODY_START = "\n  constexpr int N = "  # every SD and DR kernel body opens with it


def ssl_stamps_patch(name, src):
    """The stamps of K4's and K6's one-thread kernels (``SSL_PHASES``), in
    the SSL source that holds them; counters ``g_probe``, read by
    ``probe_read``.  Each kernel's text from its name to its closing brace
    is patched on its own."""
    kernels = [k for k in (K4_KERNEL, K6_KERNEL) if f"\n    {k}(" in src]
    if not kernels:
        return src
    src = _patch(src, '#include "ssl_task.cuh"\n', '#include "ssl_task.cuh"\n' + PROBE_HEAD)
    n = len(SSL_PHASES) + 1
    for kernel in kernels:
        start = src.index(f"\n    {kernel}(")
        end = src.index("\n}\n", start) + 2
        seg = src[start:end]
        first = seg.index(SSL_BODY_START) + 1
        seg = seg[:first] + f"  long long _t[{n}];\n  float _acc = 0.0f;\n  _t[0] = probe_clock();\n" + seg[first:]
        for anchor, text in SSL_STAMPS:
            seg = _patch(seg, anchor, text + anchor)
        seg = seg[:-2] + f"\n  _t[{n - 1}] = probe_clock();\n  probe_flush(_t, _acc);\n}}"
        src = src[:start] + seg + src[end:]
    return src


def stamps_patch(name, src):
    """The stamps build: K1's counters ``g_probe`` read by ``probe_read``,
    K2's ``g_probe_phys`` by ``probe_read_phys``; K4's and K6's
    (:func:`ssl_stamps_patch`) ``g_probe``."""
    if name.startswith("ssl_"):
        return ssl_stamps_patch(name, src)
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
# the SSL sources (the one-thread SD and DR kernels in ssl_full.cu before
# their redesign, in ssl_thread.cu since) and the header of the substeps
SSL_SOURCES = ("ssl_full.cu", "ssl_thread.cu")
SSL_HEADERS = ("ssl_body.cuh",)


def build_variant(csrc, work: Path, tag: str, patch=None, sources=VSS_SOURCES):
    """Copy ``csrc`` to ``work/tag``, apply ``patch(name, text)`` to each of
    ``sources`` that it holds (and to their family's headers), nvcc them
    with the port's flags into ``lib.so``.  Returns (ctypes library, ptxas
    parse, library path)."""
    from rsoccer_tpu_torch.ops import _build

    d = work / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    sources = [n for n in sources if (d / n).exists()]
    headers = SSL_HEADERS if any(n.startswith("ssl_") for n in sources) else VSS_HEADERS
    for name in sources + [h for h in headers if (d / h).exists()]:
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
    if hasattr(lib, SSL_ENTRIES["sd"]):
        getattr(lib, SSL_ENTRIES["sd"]).argtypes = [i, i] + [p] * 10 + [i, i, p]
        getattr(lib, SSL_ENTRIES["dr"]).argtypes = [i, i] + [p] * 6 + [i, p]
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


def ssl_operands(kind: str, batch: int, state=None):
    """SSLStaticDefenders-v0 (``kind`` "sd") or SSLDribbling-v0 ("dr")
    after 20 main-path steps at ``batch`` envs, uniform random actions;
    or the (state, action) that ``state(kind, batch)`` returns.  Returns
    ``call(lib, rng=1, emit_final=0, env_base=0, capped=False)`` (the launch
    of ``lib``'s one-thread entry on these operands; DR takes no noise and
    no env_base), ``outs(emit_final)`` and the share of 32-env warps that
    hold a done env in this launch (:func:`warp_done_share`)."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops.philox import make_key

    if state is None:
        benv = rt.make_vec(SSL_ENV_IDS[kind], batch, device="cuda", fused=True, fused_rng="kernel")
        env = benv.env
        carry, _ = R.make_rollout_fn(benv, 20)(R.init_carry(benv, seed=0))
        st = carry.state.contiguous()
        gen = torch.Generator(device="cuda").manual_seed(7)
        act = torch.rand((env.action_size, batch), generator=gen, device="cuda") * 2 - 1
    else:
        env = rt.make(SSL_ENV_IDS[kind])
        st, act = (t.contiguous() for t in state(kind, batch))
    key = make_key(3, device="cuda")
    draw = sf.sd_draw_step_rows if kind == "sd" else sf.dr_draw_step_rows
    rows = {base: draw(env, key.clone(), batch, base) for base in (0, 4096)}
    n_aux = 3 + (len(sf.SD_KEYS) if kind == "sd" else 0)
    o = {ef: (torch.empty_like(st), torch.empty((env.obs_size * (1 + ef), batch), device="cuda"),
              torch.empty((n_aux, batch), device="cuda")) for ef in (0, 1)}
    params = sf._params_struct(env)

    def call(lib, rng=1, emit_final=0, env_base=0, capped=False):
        entry = getattr(lib, SSL_ENTRIES[kind])
        outs = [t.data_ptr() for t in o[emit_final]]
        head = (emit_final, rng, ctypes.byref(params), st.data_ptr(), act.data_ptr())
        if kind == "dr":
            return lambda: entry(*head, *outs, batch, torch.cuda.current_stream().cuda_stream)
        noise = [None, None, None, key.data_ptr()] if rng else [t.data_ptr() for t in rows[env_base]] + [None]
        return lambda: entry(*head, *noise, *outs, env_base, batch, torch.cuda.current_stream().cuda_stream)

    aux = (sf.sd_full_step if kind == "sd" else sf.dr_full_step)(env, st, act, *rows[0])[2]
    return call, lambda emit_final=0: o[emit_final], float(warp_done_share((aux[1] > 0.5) | (aux[2] > 0.5)))


def warp_done_share(done):
    """The share of 32-env warps (envs 32w to 32w + 31 of the last axis of
    the bool mask ``done``) that hold a done env: in a one-thread kernel one
    done env makes its whole warp wait for its reset.  A ragged tail is
    padded with envs that are not done."""
    pad = done.new_zeros((*done.shape[:-1], -done.shape[-1] % 32))
    return torch.cat([done, pad], -1).unflatten(-1, (-1, 32)).any(-1).float().mean(-1)


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
    """The kernel label that a case name (``name[_rows]@batch``) launches."""
    base = name.split("@")[0]
    if base.startswith("k4_sd"):
        return f"{K4_KERNEL}<false,{'false' if base.endswith('_rows') else 'true'}>"
    if base.startswith("k6_dr"):
        return f"{K6_KERNEL}<false>"
    n = {"k1_3v3": 6, "k1_5v5": 10, "k1_1v0": 1, "k1_2v2": 4, "k1_4v4": 8, "k2_n6": 6, "k2_n10": 10,
         "k2_n1": 1}[name.split("@")[0].removesuffix("_rows")]
    return f"{K1_KERNEL}<{n},true>" if name.startswith("k1") else f"{K2_KERNEL}<{n}>"


def shown(lab: str) -> bool:
    """The kernels a part prints: kernel RNG (K1), 1, 6 and 10 robots; the
    SSL kernels without ``emit_final``."""
    if lab.startswith(SSL_SASS_KERNELS):
        return lab.split("<")[1].startswith("false")
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


def check_ssl_bits(base_lib, ref_lib, batches=SSL_BITS_BATCHES, state=None) -> int:
    """The base build's SD and DR one-thread entries against the reference
    build's, every output bit for bit, in both RNG modes and both obs
    variants (SD also at env_base 0 and 4096), at each of ``batches``, on
    :func:`ssl_operands`' operands (``state``: the (state, action) to step
    from).  Returns the number of comparisons; raises on a difference."""
    n = 0
    for kind in ("sd", "dr"):
        for batch in batches:
            call, outs, _ = ssl_operands(kind, batch, state)
            bases = (0, 4096) if kind == "sd" else (0,)
            for rng, ef, eb in [(rng, ef, eb) for rng in (0, 1) for ef in (0, 1) for eb in bases]:
                got = []
                for lib in (ref_lib, base_lib):
                    for t in outs(ef):
                        t.fill_(float("nan"))
                    if call(lib, rng, ef, eb)():
                        raise RuntimeError(f"{kind} launch failed")
                    torch.cuda.synchronize()
                    got.append(tuple(t.clone() for t in outs(ef)))
                if not bit_equal(*got):
                    raise AssertionError(f"{kind} at {batch} envs (rng={rng}, final={ef}, env_base={eb}): "
                                         "outputs differ from the reference build's")
                n += 1
    return n


# ---------------------------------------------------------------- parts
def run(csrc, out: Path, parts, card: str, ref=None, family: str = "vss") -> dict:
    import tempfile

    out.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="thread_probe_"))
    ssl = family == "ssl"
    sources = SSL_SOURCES if ssl else VSS_SOURCES
    res = {"card": card, "family": family, "csrc": str(csrc), "ref": str(ref) if ref else None}
    builds = {"base": (csrc, None, sources)}
    if ref:
        builds["ref"] = (ref, None, sources)
    if "sweep" in parts:
        builds.update({f"bounds_{b}_{m}": (csrc, bounds_patch(b, m), sources) for b, m in SWEEP})
    if "stamps" in parts:  # without the capped file, which would define the header's probe symbols again
        builds["stamps"] = (csrc, stamps_patch, tuple(n for n in sources if n != "vss_thread_capped.cu"))
    if "substeps" in parts:
        builds.update({f"substeps_{n}": (csrc, substeps_patch(n), sources) for n in (0, 10)})
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
        res["bits"] = (check_ssl_bits if ssl else check_bits)(base_lib, libs["ref"][0])
        print(json.dumps({"part": "bits", "card": card, "comparisons": res["bits"], "bit_equal": True}), flush=True)

    calls = {}
    if ssl:
        res["done_warp_share"] = {}
        for name, kind, batches in SSL_CASES:
            for batch in batches:
                call, _, share = ssl_operands(kind, batch)
                calls[f"{name}@{batch}"] = call
                res["done_warp_share"][f"{name}@{batch}"] = share
                if kind == "sd":  # and the input-rows variant
                    calls[f"{name}_rows@{batch}"] = lambda lib, capped=False, c=call: c(lib, 0)
        print(json.dumps({"part": "done_warp_share", "card": card, **res["done_warp_share"]}), flush=True)
    else:
        for name, kind, kw, batches in CASES:
            for batch in batches:
                call = operands(kind, batch, kw)[0]
                calls[f"{name}@{batch}"] = call
                if kind == "full":  # and the input-rows variant
                    calls[f"{name}_rows@{batch}"] = lambda lib, capped=False, c=call: c(lib, 0, capped=capped)
    if "sass" in parts:
        time_us(calls["k4_sd@131072" if ssl else "k1_3v3@131072"](base_lib))  # warm clocks before reading them
        clocks = sm_clocks()
        res["sass"] = {"clocks": clocks}
        for tag in ("base", "ref"):
            if tag not in libs:
                continue
            prof = kernel_sass(libs[tag][2], dump=out if tag == "base" else None)
            keep = {k: v for k, v in prof.items() if shown(k)}
            res["sass"][tag] = {"kernels": prof, **{f"issue_floor_us_{batch}": {
                k: issue_floor_us(v["per_env"], batch, clocks["clocks_max_sm_mhz"]) for k, v in prof.items()}
                for batch in (32768, 131072)}}
            print(json.dumps({"part": f"sass_{tag}", "card": card, "clocks": clocks,
                              "kernels": {k: {"inside": v["inside"], "outside": v["outside"],
                                              "per_env": v["per_env"],
                                              "issue_floor_us_32768_131072": [
                                                  res["sass"][tag][f"issue_floor_us_{batch}"][k]
                                                  for batch in (32768, 131072)]}
                                          for k, v in keep.items()}}), flush=True)
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
        reads = (lib.probe_read,) if ssl else (lib.probe_read, lib.probe_read_phys)
        for f in reads:
            f.argtypes = [ctypes.c_void_p]
            f(buf)
        res["stamps"] = {}
        cases = [(name, kind, None) for name, kind, _ in SSL_CASES] if ssl else [c[:3] for c in CASES]
        for name, kind, kw in cases:
            for batch in STAMP_BATCHES:
                call = (ssl_operands(kind, batch) if ssl else operands(kind, batch, kw))[0](lib)
                read = lib.probe_read if kind != "physics" else lib.probe_read_phys
                call()
                read(buf)  # reset after a warm-up launch
                call()
                read(buf)
                warps = buf[15]
                phases = SSL_PHASES if ssl else K1_PHASES if kind == "full" else K2_PHASES
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
    p.add_argument("--family", choices=("vss", "ssl"), default="vss",
                   help="the VSS one-thread kernels (K1, K2) or the SSL ones (K4, K6)")
    p.add_argument("--csrc", default=str(Path(__file__).resolve().parent.parent / "csrc"))
    p.add_argument("--ref", default=None, help="another tree's csrc: bit for bit and in turns against it")
    p.add_argument("--out", default="chiprun_out/thread_probe")
    p.add_argument("--parts", default="sass,sweep,stamps,substeps,sincos")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("thread_probe needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    return run(Path(args.csrc), Path(args.out), set(args.parts.split(",")), card, args.ref and Path(args.ref),
               args.family)


if __name__ == "__main__":
    main()
