"""The one-thread VSS kernels' launch arithmetic on the CPU (no card, no
nvcc): which C entry a batch launches (the register-capped variant for
7-10 robots on large batches), the Python mirrors of the kernels' launch
constants, and ``rsoccer_tpu_torch/tools/thread_probe.py``'s parsers (SASS
count, registers, warps per SM, issue floor) and scratch-build patches."""

import re
from pathlib import Path

import pytest

import rsoccer_tpu_torch
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
