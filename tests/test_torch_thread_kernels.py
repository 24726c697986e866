"""The one-thread kernels' launch arithmetic on the CPU (no card, no nvcc):
which C entry a batch launches (VSS: the register-capped variant for 7-10
robots on large batches; SSL: SD's and DR's one-thread kernels above the
group crossover), the Python mirrors of the kernels' launch constants,
``rsoccer_tpu_torch/tools/thread_probe.py``'s parsers (SASS count,
registers, warps per SM, issue floor, kernel labels) and scratch-build
patches of both families' sources, and the SSL world step's one heading
wrap, whose fmodf skip keeps the bits."""

import re
from pathlib import Path

import numpy as np
import pytest

import rsoccer_tpu_torch
from rsoccer_tpu_torch.ops import ssl_full as sf
from rsoccer_tpu_torch.ops import vss_full as vf
from rsoccer_tpu_torch.ops import vss_physics as vp
from rsoccer_tpu_torch.tools import thread_probe as tp

CSRC = Path(tp.__file__).resolve().parent.parent / "csrc"

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__0_11_vss_full_cu_7a17vss_thread_kernelILi6ELb1EEEv9VssParams' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__0_11_vss_full_cu_7a17vss_thread_kernelILi6ELb1EEEv9VssParams
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 9216 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__0_14_vss_physics_cu_7a25vss_physics_thread_kernelILi10EEEv13VssPhysParams' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__0_14_vss_physics_cu_7a25vss_physics_thread_kernelILi10EEEv13VssPhysParams
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__0_11_vss_full_cu_7a15vss_full_kernelILi3ELi3ELi8ELb1ELb1E11TaylorRsqrtEEvv' for 'sm_90a'
ptxas info    : Used 64 registers, used 1 barriers, 24832 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_parse_and_labels():
    regs = tp.thread_kernel_regs(tp.ptxas_kernels(PTXAS_LOG))
    assert regs == {
        "vss_thread_kernel<6,true>": {"registers": 96, "smem": 9216, "spill_bytes": 16},
        "vss_physics_thread_kernel<10>": {"registers": 167, "smem": 0, "spill_bytes": 0},
    }  # the group kernel is not a one-thread kernel


@pytest.mark.parametrize("registers, block, smem, warps", [
    (124, 64, 0, 16), (128, 64, 0, 16), (96, 64, 0, 20), (168, 64, 0, 12), (255, 64, 0, 8),
    (40, 64, 0, 48), (32, 64, 0, 64), (64, 256, 0, 32), (96, 128, 0, 20),
    (64, 64, 15360, 28),  # 14 blocks of 15 KB (and 1 KB reserved each) fill the SM's 228 KB
    (64, 64, 9216, 32),
])
def test_warps_per_sm(registers, block, smem, warps):
    assert tp.warps_per_sm(registers, block, smem) == warps


def test_issue_floor():
    # 27494 warp instructions per env, 4096 warps, 132 SMs x 4 schedulers at 1980 MHz
    assert tp.issue_floor_us(27494, 131072, 1980.0) == pytest.approx(107.72, abs=0.01)


@pytest.mark.parametrize("op, cls", [
    ("FADD", "fp32"), ("FMUL", "fp32"), ("FSETP.GEU.AND", "fp32"), ("FSEL", "fp32"), ("FMNMX", "fp32"),
    ("MUFU.RSQ", "mufu"), ("IMAD.HI.U32", "int_mul"), ("IMAD.WIDE.U32", "int_mul"), ("IMAD", "int_mul"),
    ("IMAD.MOV.U32", "other"), ("IMAD.IADD", "other"), ("BRA", "branch"), ("BSSY", "branch"),
    ("LDG.E.CONSTANT", "global"), ("STG.E", "global"), ("STL.64", "local"), ("LDS.128", "shared"),
    ("MOV", "other"),
])
def test_sass_classes(op, cls):
    assert tp.classify(op) == cls


def test_sass_profile_splits_the_substep_loop():
    # no counter check: the widest backward branch spans the loop, a
    # narrower one (an inner loop) sits inside it
    ins = [(0x00, "LDG.E", None, "R2, [R4]"), (0x10, "FADD", None, "R1, R2, R3"), (0x20, "MUFU.RSQ", None, "R5, R1"),
           (0x30, "FMUL", None, "R1, R5, R5"), (0x40, "BRA", 0x30, "0x30"), (0x50, "BRA", 0x10, "0x10"),
           (0x60, "STG.E", None, "[R4], R1"), (0x70, "EXIT", None, "")]
    prof = tp.sass_profile(ins, substeps=5)
    assert prof["n_inside"] == 5 and prof["n_outside"] == 3
    assert prof["inside"] == {"fp32": 2, "mufu": 1, "branch": 2}
    assert prof["per_env"] == 3 + 5 * 5
    assert tp.sass_profile(ins[:4])["n_inside"] == 0  # no loop: all outside


def test_sass_substep_loop_is_the_counted_one():
    # a wider backward branch (a wait loop around the whole kernel body)
    # loses to the one that compares its counter with the trip count 5
    ins = [(0x00, "FADD", None, "R1, R2, R3"), (0x10, "FMUL", None, "R1, R1, R1"), (0x20, "IADD3", None, "R7, R7, 0x1, RZ"),
           (0x30, "ISETP.NE.AND", None, "P0, PT, R7, 0x5, PT"), (0x40, "BRA", 0x10, "0x10"),
           (0x50, "LDS", None, "R2, [R0]"), (0x60, "BRA", 0x00, "0x0"), (0x70, "EXIT", None, "")]
    assert tp.substep_loop(ins, 5) == (0x10, 0x40)
    assert tp.substep_loop(ins, 10) == (0x00, 0x60)


@pytest.mark.parametrize("name", ["vss_thread.cuh", "vss_physics.cu"])
def test_scratch_patches_apply_to_the_sources(name):
    src = (CSRC / name).read_text()
    for block, min_blocks in tp.SWEEP:
        out = tp.bounds_patch(block, min_blocks)(name, src)
        assert f"kThreadBlock = {block};" in out
        want = f"__launch_bounds__(kThreadBlock, {min_blocks})" if min_blocks else "__launch_bounds__(kThreadBlock)"
        assert out.count(want) == 1
    substeps_file = "vss_step.cuh" if name == "vss_thread.cuh" else name  # where the kernel's kSubsteps is
    assert "kSubsteps = 10;" in tp.substeps_patch(10)(substeps_file, (CSRC / substeps_file).read_text())
    stamped = tp.stamps_patch(name, src)
    n = len(tp.K1_PHASES if name == "vss_thread.cuh" else tp.K2_PHASES)
    for i in range(n + 1):
        assert f"_t[{i}] = probe_clock();" in stamped
    # the files without a one-thread kernel are left alone
    for other in ("vss_full.cu", "vss_thread.cu", "vss_thread_capped.cu"):
        text = (CSRC / other).read_text()
        assert tp.stamps_patch(other, text) == text == tp.bounds_patch(64, 8)(other, text)


TEAMS = {  # robots -> VSS-v0 kwargs
    1: dict(n_robots_blue=1, n_robots_yellow=0), 4: dict(n_robots_blue=2, n_robots_yellow=2), 6: {},
    7: dict(n_robots_blue=4, n_robots_yellow=3), 8: dict(n_robots_blue=4, n_robots_yellow=4),
    10: dict(field_type=1, n_robots_blue=5, n_robots_yellow=5),
}


@pytest.mark.parametrize("n", list(TEAMS))
@pytest.mark.parametrize("wrapper", [vf, vp], ids=["vss_full", "vss_physics"])
def test_routed_entry_of_the_one_thread_kernels(wrapper, n):
    """One thread per env above the group crossover (every batch where no
    group kernel exists); above THREAD_UNCAPPED_MAX_ENVS, 7-10 robots take
    the register-capped variant, every other count the uncapped kernel."""
    env = rsoccer_tpu_torch.make("VSS-v0", **TEAMS[n])
    stem = "vss_full_step" if wrapper is vf else "vss_physics_step"
    group_max = (wrapper.GROUP_MAX_ENVS.get((env.n_blue, env.n_yellow), 0) if wrapper is vf
                 else wrapper.GROUP_MAX_ENVS.get(n, 0))
    for batch in (group_max + 1, wrapper.THREAD_UNCAPPED_MAX_ENVS, wrapper.THREAD_UNCAPPED_MAX_ENVS + 1, 131072):
        want = stem if wrapper.route(env, batch) == "group" else stem + "_one_thread" + (
            "_capped" if n in wrapper.THREAD_CAPPED_ROBOTS and batch > wrapper.THREAD_UNCAPPED_MAX_ENVS else "")
        assert wrapper.routed_entry(env, batch) == want
    assert wrapper.routed_entry(env, 131072).endswith("_capped") == (n >= 7)
    assert wrapper.THREAD_UNCAPPED_MAX_ENVS >= max(wrapper.GROUP_MAX_ENVS.values())


def test_launch_constants_mirror_the_sources():
    """``ops/vss_full``'s block and capped launch bounds are the kernels'
    (``kThreadBlock``, ``kCappedMinBlocks`` in both sources), and the capped
    robot counts are the capped entries' cases."""
    for names, wrapper in ((("vss_thread.cuh", "vss_thread_capped.cu"), vf), (("vss_physics.cu",) * 2, vp)):
        src = (CSRC / names[0]).read_text()
        assert re.search(r"constexpr int kThreadBlock = (\d+);", src).group(1) == str(vf.THREAD_BLOCK)
        assert re.search(r"constexpr int kCappedMinBlocks = (\d+);", src).group(1) == str(vf.THREAD_CAPPED_MIN_BLOCKS)
        entries = (CSRC / names[1]).read_text()
        capped = entries[entries.index("_one_thread_capped("):]
        cases = [int(c) for c in re.findall(r"THREAD\((\d+)\);", capped)]
        assert cases == list(wrapper.THREAD_CAPPED_ROBOTS)
    # 8 blocks of 64 threads at 128 registers: 16 warps per SM, no shared memory
    assert tp.warps_per_sm(65536 // (vf.THREAD_CAPPED_MIN_BLOCKS * vf.THREAD_BLOCK), vf.THREAD_BLOCK) == 16


# ---------------------------------------------------------------- the SSL one-thread kernels (K4, K6)
SSL_MANGLED = {
    "_ZN44_GLOBAL__N__0_13_ssl_thread_cu_7a1a03a716sd_thread_kernelILb1ELb1EEEv9SslParamsPKfS3_S3_S3_S3_PKxjPfS6_S6_i":
        "sd_thread_kernel<true,true>",
    "_ZN44_GLOBAL__N__0_13_ssl_thread_cu_7a1a03a716sd_thread_kernelILb0ELb1EEEv9SslParamsPKfS3_S3_S3_S3_PKxjPfS6_S6_i":
        "sd_thread_kernel<false,true>",
    "_ZN44_GLOBAL__N__0_13_ssl_thread_cu_7a1a03a716dr_thread_kernelILb0EEEv9SslParamsPKfS3_PfS4_S4_i":
        "dr_thread_kernel<false>",
    "_ZN44_GLOBAL__N__0_11_ssl_full_cu_7a1a03a714cp_full_kernelILb0ELb1EEEv9SslParamsPKfS3_S3_PKxjPfS6_S6_i":
        "cp_full_kernel<false,true>",
    "_ZN44_GLOBAL__N__0_11_ssl_full_cu_7a1a03a714pe_full_kernelILb1ELb0EEEv9SslParamsPKfS3_S3_S3_PKxjPfS6_S6_i":
        "pe_full_kernel<true,false>",
    # the group kernels are not one-thread kernels
    "_ZN44_GLOBAL__N__0_11_ssl_full_cu_7a1a03a714sd_full_kernelILb0ELb1EEEv9SslParamsPKfS3_S3_S3_S3_PKxjPfS6_S6_i": None,
    "_ZN44_GLOBAL__N__0_11_ssl_full_cu_7a1a03a714dr_full_kernelILb1EEEv9SslParamsPKfS3_PfS4_S4_i": None,
}


@pytest.mark.parametrize("mangled", list(SSL_MANGLED))
def test_ssl_kernel_labels(mangled):
    assert tp.kernel_label(mangled) == SSL_MANGLED[mangled]


@pytest.mark.parametrize("name, label", [
    ("void (anonymous namespace)::sd_thread_kernel<true, true>(SslParams, float const*)", "sd_thread_kernel<true,true>"),
    ("void (anonymous namespace)::dr_thread_kernel<false>(SslParams, float const*)", "dr_thread_kernel<false>"),
    ("void (anonymous namespace)::cp_full_kernel<false, true>(SslParams)", "cp_full_kernel<false,true>"),
    ("void (anonymous namespace)::sd_full_kernel<false, true>(SslParams)", None),
])
def test_ssl_labels_of_profiler_names(name, label):
    assert tp.label_of_demangled(name) == label


def test_ssl_case_labels_and_shown():
    """The probe's SSL cases name the kernels they launch (no emit_final;
    input rows: RNG false), and the parts print those variants."""
    assert tp.label("k4_sd@131072") == "sd_thread_kernel<false,true>"
    assert tp.label("k4_sd_rows@32768") == "sd_thread_kernel<false,false>"
    assert tp.label("k6_dr@131072") == "dr_thread_kernel<false>"
    assert tp.shown("sd_thread_kernel<false,true>") and tp.shown("dr_thread_kernel<false>")
    assert not tp.shown("sd_thread_kernel<true,true>") and not tp.shown("cp_full_kernel<true,false>")
    assert not tp.has_capped("k4_sd@131072")


def test_ssl_ptxas_parse():
    log = "".join(f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'\n"
                  f"    0 bytes stack frame, {8 * i} bytes spill stores, 0 bytes spill loads\n"
                  f"ptxas info    : Used {96 + 8 * i} registers, used 0 barriers, 3072 bytes smem\n"
                  for i, m in enumerate(SSL_MANGLED))
    regs = tp.thread_kernel_regs(tp.ptxas_kernels(log))
    assert sorted(regs) == sorted(v for v in SSL_MANGLED.values() if v)
    assert regs["sd_thread_kernel<true,true>"] == {"registers": 96, "smem": 3072, "spill_bytes": 0}
    assert regs["dr_thread_kernel<false>"] == {"registers": 112, "smem": 3072, "spill_bytes": 16}


@pytest.mark.parametrize("block, min_blocks", tp.SWEEP)
def test_ssl_bounds_patch_applies_to_the_sources(block, min_blocks):
    """The sweep rebuilds SD's and DR's one-thread kernels (ssl_thread.cu)
    at each block and bound; ssl_full.cu has none of them."""
    src = (CSRC / "ssl_thread.cu").read_text()
    out = tp.bounds_patch(block, min_blocks)("ssl_thread.cu", src)
    assert f"kThreadBlock = {block};" in out
    want = f"__launch_bounds__(kThreadBlock, {min_blocks})" if min_blocks else "__launch_bounds__(kThreadBlock)"
    assert len(re.findall(re.escape(want) + r"\n    (sd|dr)_thread_kernel\(", out)) == 2
    full = (CSRC / "ssl_full.cu").read_text()
    assert "thread_kernel(" not in tp.bounds_patch(block, min_blocks)("ssl_full.cu", full)


def test_ssl_substeps_and_stamps_patches_apply_to_the_sources():
    body = (CSRC / "ssl_body.cuh").read_text()
    assert "kSslSubsteps = 10;" in tp.substeps_patch(10)("ssl_body.cuh", body)
    assert "kSslSubsteps = 0;" in tp.substeps_patch(0)("ssl_body.cuh", body)
    src = (CSRC / "ssl_thread.cu").read_text()
    stamped = tp.stamps_patch("ssl_thread.cu", src)
    assert len(tp.SSL_STAMPS) + 1 == len(tp.SSL_PHASES)  # a stamp between each two phases
    for kernel in (tp.K4_KERNEL, tp.K6_KERNEL):  # every stamp once in each kernel
        start = stamped.index(f"\n    {kernel}(")
        seg = stamped[start:stamped.index("\n}\n", start)]
        for i in range(len(tp.SSL_PHASES) + 1):
            assert seg.count(f"_t[{i}] = probe_clock();") == 1, (kernel, i)
        assert seg.count("probe_flush(_t, _acc);") == 1
    assert stamped.count("__device__ unsigned long long g_probe[16];") == 1
    for other in ("ssl_full.cu",):  # no SD or DR one-thread kernel left there
        text = (CSRC / other).read_text()
        assert tp.stamps_patch(other, text) == text


@pytest.mark.parametrize("batch", [32, 64, 8191, 8192])
def test_warp_done_share(batch):
    """The share of 32-env warps that hold a done env: per row of a
    (steps, batch) mask, a ragged last warp counted as a warp."""
    import torch

    done = torch.zeros((3, batch), dtype=torch.bool)
    done[1, 0] = True  # one env of the first warp
    done[2, ::32] = True  # one env of every warp
    done[2, -1] = True  # and the last env, in the last (maybe ragged) warp
    warps = -(-batch // 32)
    want = torch.tensor([0.0, 1.0 / warps, 1.0])
    assert torch.allclose(tp.warp_done_share(done), want)
    assert float(tp.warp_done_share(done[1])) == pytest.approx(1.0 / warps)


@pytest.mark.parametrize("entry", sf.GROUP_ENTRIES)
def test_ssl_routed_entry_on_both_sides_of_the_crossover(entry):
    """SD and DR launch their group kernel up to their GROUP_MAX_ENVS and
    their one-thread kernel above; CP and PE their one kernel at every
    batch."""
    top = sf.GROUP_MAX_ENVS[entry]
    for batch in (1, top - 1, top):
        assert sf.route(entry, batch) == "group" and sf.routed_entry(entry, batch) == entry
    for batch in (top + 1, 16385, 131072):
        assert sf.route(entry, batch) == "thread" and sf.routed_entry(entry, batch) == entry + "_one_thread"
    for other in ("ssl_cp_full_step", "ssl_pe_full_step"):
        assert sf.routed_entry(other, top + 1) == other


def test_ssl_launch_constants_mirror_the_sources():
    """ops/ssl_full's THREAD_BLOCK is the one-thread SD and DR kernels'
    kThreadBlock, and their launch bounds leave SD 128 registers (16 warps
    per SM) and DR 80 (24); the one-thread SD kernel's spawn rounds are one
    env per 8-lane group."""
    thread = (CSRC / "ssl_thread.cu").read_text()
    assert re.search(r"constexpr int kThreadBlock = (\d+);", thread).group(1) == str(sf.THREAD_BLOCK)
    m = re.search(r"constexpr int kSdMinBlocks = (\d+), kDrMinBlocks = (\d+);", thread)
    sd_regs, dr_regs = (65536 // (int(g) * sf.THREAD_BLOCK) for g in m.groups())
    assert (sd_regs, dr_regs) == (128, 85)  # ptxas rounds DR's cap down to 80
    assert tp.warps_per_sm(128, sf.THREAD_BLOCK) == 16 and tp.warps_per_sm(80, sf.THREAD_BLOCK) == 24
    assert "__launch_bounds__(kThreadBlock, kSdMinBlocks)\n    sd_thread_kernel(" in thread
    assert "__launch_bounds__(kThreadBlock, kDrMinBlocks)\n    dr_thread_kernel(" in thread
    assert "constexpr int kRoundEnvs = 32 / kGroup;" in thread
    assert re.search(r"constexpr int kGroup = (\d+);", (CSRC / "lane_group.cuh").read_text()).group(1) == "8"
    assert sf.K == 8  # candidate k on lane k of a group


def test_ssl_one_wrap_for_every_kernel():
    """The group world step (ssl_world.cuh) and the one-thread one
    (ssl_body.cuh) wrap headings with the same function, defined once."""
    body, world = (CSRC / "ssl_body.cuh").read_text(), (CSRC / "ssl_world.cuh").read_text()
    assert body.count("float ssl_wrap_angle(") == 1 and "ssl_wrap_angle(" in body.split("float ssl_wrap_angle(")[1]
    assert "float ssl_wrap_angle" not in world and "fmodf" not in world
    assert world.count("ssl_wrap_angle(r.th + r.w * p.dts, p.pi, p.two_pi)") == 1
    assert '#include "ssl_body.cuh"' in world


def _fmod32(x, y):
    return np.fmod(np.float32(x), np.float32(y))  # exact, the dividend's sign, as fmodf


def wrap_plain(t, pi, two_pi):
    """ssl_body.cuh's wrap before it skipped fmodf (every f32 through it)."""
    r = _fmod32(np.float32(t) + pi, two_pi)
    if r != 0.0 and r < 0.0:
        r = np.float32(r + two_pi)
    return np.float32(r - pi)


def wrap_fast(t, pi, two_pi):
    """ssl_body.cuh's ssl_wrap_angle: fmodf only outside [0, 2 pi)."""
    r = np.float32(np.float32(t) + pi)
    if not (r >= 0.0 and r < two_pi):
        r = _fmod32(r, two_pi)
        if r != 0.0 and r < 0.0:
            r = np.float32(r + two_pi)
    return np.float32(r - pi)


def test_ssl_fast_wrap_gives_the_plain_wraps_bits():
    """Where t + pi lies in [0, 2 pi), fmodf returns it exactly, so the
    skip cannot change a bit; held here on f32 inputs around every edge
    (zeros, +-pi, +-2 pi and their neighbours, large, infinite, NaN) and
    on random ones."""
    pi, two_pi = np.float32(np.pi), np.float32(2 * np.pi)
    edges = [0.0, -0.0, pi, -pi, two_pi, -two_pi, 3 * pi, -3 * pi, 1e-30, -1e-30, 1e30, -1e30, np.inf, -np.inf,
             np.nan]
    xs = [np.float32(v) for v in edges]
    xs += [np.nextafter(np.float32(v), np.float32(d)) for v in (pi, -pi, two_pi, -two_pi, 0.0)
           for d in (np.inf, -np.inf)]
    rng = np.random.default_rng(0)
    xs += list(rng.uniform(-20, 20, 4000).astype(np.float32)) + list(rng.uniform(-4, 4, 4000).astype(np.float32))
    with np.errstate(invalid="ignore"):
        for x in xs:
            a, b = wrap_plain(x, pi, two_pi), wrap_fast(x, pi, two_pi)
            assert np.asarray(a).view(np.uint32) == np.asarray(b).view(np.uint32), x
