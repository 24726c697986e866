"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline DIR


Builds the port's CUDA kernels from ``rsoccer_tpu_torch/csrc`` (one nvcc per
source, in parallel, at first use) and, for each fused env step —
VSS-v0 (``vss_full_step``), SSLStaticDefenders-v0 (``ssl_sd_full_step``),
SSLContestedPossession-v0 (``ssl_cp_full_step``), SSLDribbling-v0
(``ssl_dr_full_step``) and SSLPassEndurance-v0 (``ssl_pe_full_step``) —
holds the kernel against its plain PyTorch version at the main path's
shapes (8192 envs), in both RNG modes and both obs variants, through
auto-resets; the Dribbling and PassEndurance checks start from lanes built
next to each gate and on pass lines, and print the crossings, completions
and receptions they saw.  The VSS physics kernel (``vss_physics``) is held
to its plain version on every step of a ``fused_physics`` rollout, and that
rollout to the unfused one.  The VSS fused step, the physics kernel and the
StaticDefenders and Dribbling steps (both RNG modes) are held to their
plain versions again at a ragged batch (8191 envs: the last block part
empty), as are the ContestedPossession and PassEndurance steps, and the
StaticDefenders and Dribbling steps also at 16384 envs, where their
wrappers launch the one-thread kernels.  VSS-v0 at 5v5 on its own
field, at 1v0 and at 3v3 beyond the Taylor bound (``time_step`` 0.1) is
held the same way at 8192 and 8191 envs (5v5 on the 16-lane group kernel,
and on the one-thread kernel just above its crossover; 1v0 on the
one-thread kernel; at 3v3 the group kernel's exact-trig policy),
the physics kernel at 5v5 (16 lanes) and 1v0 (one thread), and at 3v3 and
5v5 the one-thread VSS kernels are held bit for bit to the group kernels
at 32768 envs (at 5v5 also their register-capped variants).  The VSS
kernels and K4-K7 are timed at 32768 and 131072 envs through their
wrappers' routes, and the one-thread VSS kernels (3v3, 5v5; K2 at N = 6,
10) and K4's and K6's one-thread kernels through the one-thread entry the
route names there, with their registers, spills, warps per SM and SASS
issue floor (``kernel_scale_one_thread``), and the share of SD's and DR's
32-env warps that hold a done env per step there (``done_share_*``).  Then it drives each main path —
``BatchedEnv(<id>, 8192, device="cuda", fused=True, fused_rng="kernel")``,
``BatchedEnv(VSS-v0, 8192, device="cuda", fused_physics=True)``, and
``make_vec("VSS-v0", 8192, ..., field_type=1, n_robots_blue=5,
n_robots_yellow=5)`` and ``make_vec("VSS-v0", 8192, ..., n_robots_blue=1,
n_robots_yellow=0)`` fused and ``fused_physics`` —
through ``make_rollout_fn`` with every launch count set to 0 just before and
read just after (also by the C entry the wrapper's route names, and the
rollout epilogue's one launch a step and one finish a call), and times it,
with the loop's device time and launches a step outside the env kernel
read from the port's spans (``rollout_device_*``); from the main path's
last carry it holds the rollout epilogue to the plain torch bookkeeping
on the card for 20 steps (``epilogue_vs_plain_*``: the carries bit for
bit, the episode count and length sum exact and the reward sums within
rel 1e-6 of a float64 recount), and it times the epilogue alone at
1048576 envs against the plain bookkeeping (``rollout_epilogue_time``, a
record in the kernels' line);
for the ContestedPossession and PassEndurance paths it prints the share of
envs, and of 32-env warps, that hold a done env per step.  Each phase
prints one line; any failure exits non-zero.  The last two lines are the
kernels' JSON record and ``{"ok": true, ...}``.

With ``--baseline DIR`` it runs instead one comparison against the kernels
built from another tree's sources in DIR (its ``rsoccer_tpu_torch/csrc``,
for example the parent commit's, unpacked with ``git archive``): this
tree's one-thread VSS kernels bit for bit against DIR's at 1v0, 2v2, 3v3
and 5v5 (K2 at N = 1, 4, 6, 10; both RNG modes, both obs variants, both
trig policies, ``env_base`` 0 and 4096) at 8191, 16385 and 8192-131072
envs; the 3v3 group kernels bit for bit against DIR's and the one-thread
kernels, all timed in turns (DIR's one thread, group, one thread, one
thread, group, DIR's one thread) from 8192 to 131072 envs (the
group-vs-one-thread crossover), 1v0 likewise without a group kernel; the
5v5 group kernels bit for bit against DIR's one-thread kernels and this
tree's (with their capped variants), timed in turns the same way, with
the routed entry beside the fastest design (the 5v5 crossovers); the
StaticDefenders and Dribbling one-thread entries bit for bit against DIR's
at 8191, 8449, 16385, 32768 and 131072 envs (both RNG modes, both obs
variants, ``env_base`` 0 and 4096); all four SSL steps, outputs bit for bit
at 8192 to 131072 envs (in both RNG modes and both obs variants), then
each timed in turns (baseline, this, this, baseline), the StaticDefenders
and Dribbling steps' group and one-thread entries both, with the route at
each batch beside the faster design and the routed kernel's time beside
the baseline's.
Then the learner of the main path (``rsoccer_tpu_torch/models/ppo.py``):
``ppo_train`` trains PPO on VSS-v0 at 8192 envs through K1's
``emit_final`` variant (towers (256, 256) in bf16, 128 steps x 4 epochs x
8 minibatches, 10 updates from a fresh init, counts zeroed before and read
after), printing each update's reward, loss, entropy and collect / update
ms; ``ppo_resume`` saves and restores the whole training state and holds
one more update from each bit for bit; ``ppo_profile`` gives K1's share of
the collect step and times the variant against its plain version;
``ppo_checkpoint`` loads the shipped ``artifacts/vss_ppo.ckpt.npz``
without jax and holds its VSS anchor (1024 envs x 4800 steps) to the
two-sample 3-sigma band around ``artifacts/README.md``'s numbers;
``ppo_ssl_checkpoints`` does the same for the SSL PPO checkpoints on K4,
K5 and K6.
Then SAC (``rsoccer_tpu_torch/models/sac.py``): ``sac_train`` trains it on
SSLStaticDefenders-v0 at 512 envs through K4's group kernel and its
``emit_final`` variant (the SD recipe: towers (256, 256) f32, batch 512, 2
grad steps, a ring of 1 << 18, n-step 8; 1000 iterations from a fresh
init, counts zeroed before and read after), printing iterations/s,
env-steps/s and collect / update ms; ``sac_resume`` saves and restores
the whole state, replay ring included, and holds one more iteration from
each bit for bit; ``sac_profile`` gives K4's device time per launch in an
iteration and alone at 512 envs, with its bound and its share of the
collect, and the iteration's device time and top kernels;
``sac_checkpoint`` scores the shipped ``sac_sd_best2`` (K4) and
``sac_cp_nstep`` (K5) against their 3-sigma bands.
Then the scripted experts and BC (``rsoccer_tpu_torch/experts.py``,
``rsoccer_tpu_torch/tools/bc_warmstart.py``): ``expert_score`` runs each
expert on its reference-exact env, every step ``unpack_state`` -> the
expert -> one launch of K4 (SD, 1024 envs x 2000 steps), K7 (PE, 1024 x
2400) or K6 (DR, 256 x 5100), against the JAX tests' floors, with the
host and device time per step and the expert's alone; ``bc_train`` runs
the BC tool in-process at the ``pe_bc`` recipe cut to one DAgger round
(two rounds of 262,144 expert pairs from curriculum resets, 40 epochs
each, the clone's eval through K7), saves ``chiprun_out/pe_bc_port.ckpt.npz`` and re-scores it
after a reload, and profiles a few collect steps and one fit epoch;
``bc_checkpoints`` scores ``pe_bc``, ``pe_rl``, ``sac_sd_cloneseed``,
``drb_sac``, ``sac_pe_nstep``, ``sd_bc`` and ``sd_sac_bc`` at 1024 envs,
each against its band (around the JAX package's own score where the
published one does not reproduce there or has no count), and each
Dribbling run, the expert's too, also on its course length.  Each of these phases zeroes
the launch counts before it and fails unless every env step was one
launch of its env's routed entry, without ``emit_final``, and no other
kernel launched.
Then multi-agent VSS and self-play (``rsoccer_tpu_torch/envs/vss_multiagent.py``,
``envs/vss_selfplay.py``, ``models/selfplay.py``), whose one kernel path is
the VSS physics kernel (``fused_physics``): it is held to its plain
version under policy-like actions of every robot on both envs at 8192
and 8191 envs (in section 3), ``VSSMultiAgent-v0``'s main path is driven
and timed (section 4); ``selfplay_train`` runs
``examples/selfplay_vss.py`` in-process at the round-5 recipe cut to 6
updates (2048 envs, half the lanes OU, anchor-gated swaps every 3, a
``selfplay_swap`` line each), ``selfplay_resume`` holds one more update
from a saved and restored state (the frozen opponent's payload included)
bit for bit, and ``selfplay_checkpoint`` scores the two shipped league
policies on the ``VSSMultiAgent-v0`` anchor (1024 envs x 4800 steps)
against their published bands; each counts one physics-kernel launch per
env step and no other launch.
Last, the numpy core of the gymnasium wrappers (``rsoccer_tpu_torch/batch/host.py``):
``gym_vector_<task>`` drives ``HostVectorEnv`` (what ``VectorGymnasiumEnv``
steps) at 8192 envs through K1's and K4-K7's ``emit_final`` variants with
kernel RNG, holds it to the unfused ``HostVectorEnv`` on the card over 6
steps at a step limit of 3 (every env through a SAME_STEP reset, one
launch per step, counts zeroed before), then times it at the normal step
limit (host ms per step, the kernel's device time, the bytes copied to the
host, env-steps/s); ``gym_single_vss`` holds ``HostEnv("VSS-v0")`` (what
``GymnasiumEnv`` steps) on the card to the same on the CPU and times it;
``host_views`` holds ``frame_from_batched`` of the card's unpacked K1 and
K4 states to ``frame_from_world`` of the same env copied to the CPU;
``custom_env`` runs ``examples/custom_env.py``'s ``ReachBallEnv`` at 8192
envs and holds its touch step to the CPU's.  gymnasium and pygame do not
import on the card's machine: the gymnasium classes, the renderer and the
GIF export are held by the CPU tests (``tests/test_torch_gym_compat.py``,
``tests/test_torch_frame_render.py``, ``tests/test_torch_video_examples.py``).
The ``fused_physics`` main paths run 1 warm-up and 2 timed rollouts and
profile 5 steps (the other main paths 2, 5 and 20), with the same gates.
Data parallelism (``rsoccer_tpu_torch/parallel/``): right after the
kernel checks, ``kernel_vs_plain_env_base_<task>`` holds K1 and K4-K7 on
a shard at ``env_base`` B/2 to their plain versions and, bit for bit, to
the unsharded batch's columns; last, ``parallel_rollout``,
``parallel_ppo`` and ``parallel_sac`` run two worker ranks (``--parallel-
worker``: this script in two processes, gloo, sharing the card, alone on
it) and then one nccl rank in this process: the sharded VSS-v0 rollout at
B global envs (its ranks' states and obs, concatenated, equal the
unsharded rollout's bit for bit, K1 once per step per rank; the shard_map
variant's shards draw apart and its key comes back replicated), the
sharded PPO in both minibatch modes with f32 towers (two ranks within rel
1e-4 of one, the params bit-identical across the ranks; the bf16 recipe
timed), the sharded SAC at the SD recipe (networks bit-identical across
the ranks, each ring holding its envs' transitions), each one-rank run
bit for bit its unsharded counterpart; ``elastic_resume`` crashes and
resumes ``rsoccer_tpu_torch/tools/elastic_train.py`` (PPO, SAC) to equal
digests.
Last, the tools (``rsoccer_tpu_torch/tools/``), each in-process through
its ``main(argv)``, the launch counts zeroed before and read after:
``tool_bench_all`` (the five ids at 8192 envs in modes 0, full and
full-krng, VSS-v0 in mode 1: every fused point one launch of its routed
entry per env step), ``tool_profile_step`` (VSS-v0 full-krng: K1 once
per step in the profiled window), ``tool_profile_ppo`` and
``tool_profile_sac`` (SD at 4096 and 512 envs, fused: K4's
``emit_final`` variant once per env step), ``tool_roofline_ppo`` and
``tool_roofline_sac`` (the matmul FLOPs the profiler counts equal the
towers' count from their shapes, MFU at most 100%, the kernel classes
summing to the device total) and ``tool_sd_spawn_slice`` (``sd_ppo3`` at
1024 envs x 2000 steps on K4: every spawn bin's goal rate inside the
two-sample 3-sigma band around the JAX tool's own output); each phase
line lists its depth cuts.
Last, the physics calibration and the C++ oracles
(``rsoccer_tpu_torch/tools/calibrate.py``, ``ops/native.py``):
``calibrate_selftest`` runs the calibration self-test on the card at the
JAX tool's size (6 robots, T = 80, 300 iterations; the loss falls by 1e3,
``robot_accel`` and ``ball_friction_decel`` recovered within
tests/test_calibrate.py's bounds; the first loss and gradients within rel
1e-4 of the CPU's), ``calibrate_timed_fit`` times a fit of 8192
transitions (ms per iteration by CUDA events, device us and the busy
share by the profiler), and ``native_oracle_vss_physics_{3v3,5v5}`` and
``native_oracle_ssl_plain`` hold K2 at 8192 envs and the plain SSL
physics at 1024 envs to the C++ oracle on each of 20 steps (2e-4, wheel
speeds 5e-3, infrared exact), printing the worst error per leaf; K2
launches once per step through its routed entry.
Imports nothing of JAX.  Long output goes to ``chiprun_out/``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from rsoccer_tpu_torch.ops.bounds import (
    CP_OPS, DR_OPS, PE_OPS, SD_OPS, bound_ms, vss_full_ops, vss_physics_ops,
)
from rsoccer_tpu_torch.core.state import tree_map
from rsoccer_tpu_torch.ops import rollout_epilogue
from rsoccer_tpu_torch.tools import _trace
from rsoccer_tpu_torch.utils import tracing

B = 8192
RAGGED_B = 8191  # leaves the last 32-env block of the group kernels part empty
ONE_THREAD_B = 16384  # above ops/ssl_full.GROUP_MAX_ENVS' crossovers: the one-thread SD and DR kernels
SCALE_BATCHES = (32768, 131072)
VSS_THREAD_B = 32768  # the VSS group and one-thread kernels, checked bit for bit at 3v3 and 5v5
# VSS-v0 beyond 3v3 and the Taylor bound: 5v5 on its own field (state 95
# rows, obs 64), 1v0 (no robot pairs), 3v3 with exact trig each substep
VSS_CONFIGS = {
    "5v5": dict(field_type=1, n_robots_blue=5, n_robots_yellow=5),
    "1v0": dict(n_robots_blue=1, n_robots_yellow=0),
    "3v3_dt0.1": dict(time_step=0.1),
}
VSS_5V5_EXACT = dict(VSS_CONFIGS["5v5"], time_step=0.1)  # 5v5 beyond the Taylor bound
# the group-vs-one-thread crossover of the VSS kernels, timed in turns
VSS_CROSSOVER_BATCHES = (B, 10240, 16384, 24576, 32768, 65536, 131072)
N_CHECK_STEPS = 5
WARM_STEPS = 60  # SSL checks start mid-episode: contacts, dribbling, kicks
ROLLOUT_STEPS = 100
PROFILE_ROLLOUT_STEPS = 20  # the profiled rollout (the profiler's own cost per launch dominates it)
LOOP_PROBE_CALLS = 4  # profiled calls of the rollout read by its spans (tools/_trace.rollout_loop)
EPILOGUE_STEPS = 20  # each main path's rollout epilogue held to the plain bookkeeping
EPILOGUE_TIMED_B = 1 << 20  # the epilogue and the plain bookkeeping timed alone (the VSS rollout cell's batch)
EPILOGUE_SETS = 6  # their operand sets, taken in turn: 6 x 23 MB, past the L2
TIMED_ROLLOUTS = 5
# the fused_physics main paths (~700 launches and 9-18 ms of host time a
# step): 1 warm-up and 2 timed rollouts, 5 profiled steps (the others 2, 5
# and 20), the same gates
PHYSICS_DEPTH = dict(warm_rollouts=1, timed_rollouts=2, profile_steps=5)
TIMED_LAUNCHES = 200
ATOL = 5e-5
OUT_DIR = "chiprun_out"


_T0 = time.perf_counter()


def phase(name, **fields):
    """One phase's line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({"phase": name, **fields, "t_s": time.perf_counter() - _T0}), flush=True)


def make_env(task):
    import rsoccer_tpu_torch as rt

    return rt.make(task.env_id, **task.env_kwargs)


def card_line() -> str:
    return _trace.card_line(torch.device("cuda", 0))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def worst_entry(d: torch.Tensor) -> tuple[float, int, int]:
    """(largest value, its row, its lane) of a (rows, B) error table; zeros
    for a table with no rows (DR has no info rows)."""
    if not d.numel():
        return 0.0, 0, 0
    i = int(d.argmax())
    return float(d.flatten()[i]), i // d.shape[-1], i % d.shape[-1]


def compare_step(n, got, want, tag):
    """Kernel outputs vs plain outputs of one step.  Floats to ATOL;
    headings on the circle (a wrap at +-pi is the same angle); steps,
    terminated, truncated exactly.  Returns the largest float error and
    where it is (part, row, lane, tag)."""
    st_k, obs_k, aux_k = got
    st_p, obs_p, aux_p = want
    steps_row = 6 + 6 * n
    th = slice(6 + 2 * n, 6 + 3 * n)
    d = (st_k - st_p).abs()
    dth = torch.remainder(st_k[th] - st_p[th] + math.pi, 2 * math.pi) - math.pi
    d[th] = dth.abs()
    d[steps_row] = 0.0  # held exactly below
    errs = {
        "state": worst_entry(d),
        "obs": worst_entry((obs_k - obs_p).abs()),
        "reward": worst_entry((aux_k[:1] - aux_p[:1]).abs()),
        "shaping": worst_entry((aux_k[3:] - aux_p[3:]).abs()),
    }
    bad = {k: v for k, v in errs.items() if not v[0] <= ATOL}
    if bad:
        raise AssertionError(f"{tag}: kernel vs plain beyond {ATOL} (error, row, lane): {bad}")
    if not torch.equal(st_k[steps_row], st_p[steps_row]):
        raise AssertionError(f"{tag}: steps differ")
    for name, row in (("terminated", 1), ("truncated", 2)):
        if not torch.equal(aux_k[row], aux_p[row]):
            raise AssertionError(f"{tag}: {name} differ")
    part, (err, row, lane) = max(errs.items(), key=lambda kv: kv[1][0])
    return err, {"part": part, "row": row, "lane": lane, "at": tag}


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


def dribble_actions(obs, gen):
    """SSLDribbling-v0 actions (vx, vy, vtheta, dribbler): even envs drive
    at the ball (obs 1-2; the robot at obs 5-6) with the dribbler on, odd
    envs act at random."""
    u = torch.rand((4, obs.shape[-1]), generator=gen, device=obs.device) * 2 - 1
    dx, dy = obs[1] - obs[5], obs[2] - obs[6]
    norm = torch.sqrt(dx * dx + dy * dy) + 1e-6
    chase = torch.arange(obs.shape[-1], device=obs.device) % 2 == 0
    u[0] = torch.where(chase, dx / norm, u[0])
    u[1] = torch.where(chase, dy / norm, u[1])
    u[3] = torch.where(chase, 1.0, u[3])
    return u


def pass_actions(obs, gen):
    """SSLPassEndurance-v0 actions (vtheta, kick, dribbler): even envs turn
    the shooter (obs 4-7) toward the receiver (obs 10-11), dribbler on, and
    kick when aligned with the ball on the kicker; odd envs act at random."""
    u = torch.rand((3, obs.shape[-1]), generator=gen, device=obs.device) * 2 - 1
    dx, dy = obs[10] - obs[4], obs[11] - obs[5]
    sn, cs = obs[6], obs[7]
    err = torch.atan2(cs * dy - sn * dx, cs * dx + sn * dy)
    aim = torch.arange(obs.shape[-1], device=obs.device) % 2 == 0
    u[0] = torch.where(aim, torch.clamp(err, -1.0, 1.0), u[0])
    u[1] = torch.where(aim, ((err.abs() < 0.02) & (obs[9] > 0.5)).to(u.dtype), u[1])
    u[2] = torch.where(aim, 1.0, u[2])
    return u


DR_KINDS = ("cross0", "cross1", "cross_even", "reverse_even", "cross_odd", "completed",
            "rbt_out", "collision")


def dr_gate_states(st, share: float = 0.5):
    """Overwrite the first ``share`` of packed SSLDribbling-v0 lanes with
    worlds built on each branch of the gate automaton, cycling through
    ``DR_KINDS``: the ball just across y = 0 inside the gate's x-window and
    moving across it (checkpoint counts 0..6 as the branch needs), the
    robot behind it, the yellows at rest on the nodes; ``rbt_out`` puts the
    robot outside the course box, ``collision`` sets a yellow moving.
    Returns (state, kind per lane; -1 where not built)."""
    st = st.clone()
    n, b = 5, st.shape[-1]
    lane = torch.arange(b, device=st.device)
    kind = torch.where(lane < int(share * b), lane % len(DR_KINDS), -1)
    cyc = (lane // len(DR_KINDS)) % 3  # which even/odd count a branch takes
    count = torch.stack([
        torch.zeros_like(lane), torch.ones_like(lane), 2 + 2 * (cyc % 2), 2 + 2 * cyc,
        3 + 2 * (cyc % 2), torch.full_like(lane, 6), lane % 7, lane % 7,
    ])[kind.clamp(min=0), lane]
    gate_x = torch.tensor([-0.75, -1.25, -1.75, -1.75, -2.5, -1.75, -0.75, -0.75],
                          device=st.device)[kind.clamp(min=0)]
    up = (kind == 1) | (kind == 3) | (kind == 4)
    jitter = ((lane * 37) % 101).to(st.dtype) / 100.0 - 0.5
    bx = gate_x + 0.2 * jitter
    ball = torch.stack([bx, torch.where(up, -0.01, 0.01), torch.full_like(bx, 0.0215),
                        torch.zeros_like(bx), torch.where(up, 0.8, -0.8), torch.zeros_like(bx)])
    rx = torch.stack([torch.where(kind == 6, 1.2, bx + 0.3)]
                     + [torch.full_like(bx, x) for x in (-0.5, -1.0, -1.5, -2.0)])
    zeros = torch.zeros((n, b), device=st.device)
    yvx = zeros.clone()
    yvx[1] = torch.where(kind == 7, 1.0, 0.0)
    ry = zeros.clone()
    ry[0] = 0.3
    rows = torch.cat([ball, rx, ry, torch.full_like(zeros, math.pi), yvx, zeros, zeros,
                      st[6 + 6 * n:7 + 6 * n], count[None].to(st.dtype)])
    built = kind >= 0
    st[:, built] = rows[:, built]
    return st, kind


PE_KINDS = ("pass", "stopped", "out", "edge")


def pe_pass_states(st, share: float = 0.5):
    """Overwrite the first ``share`` of packed SSLPassEndurance-v0 lanes,
    cycling through ``PE_KINDS``: ``pass`` puts the ball in flight along
    the receiver's heading, 0.02-0.15 m short of its kicker face with a
    lateral offset up to 0.05 m, at 1.5 m/s; ``stopped`` rests the ball
    between the robots with the stopped counter at 20; ``out`` sends the
    ball out of the shooter-receiver box; ``edge`` rolls the ball at 2.5 m/s
    (above the capture speed) onto the lateral edge of the receiver's kicker
    face, 0.0372-0.0398 m off its axis, where testing the face before or after
    the positional push decides the restitution.  Returns (state, kind per
    lane; -1 where not built)."""
    st = st.clone()
    n, b = 2, st.shape[-1]
    lane = torch.arange(b, device=st.device)
    kind = torch.where(lane < int(share * b), lane % len(PE_KINDS), -1)
    # in (0, 1), spread over lanes, never a round value: no ball starts on a
    # face-zone edge (|side| = 0.04), where an ulp decides
    frac = (((lane * 37) % 101).to(st.dtype) + 0.5) / 101.0
    sx, sy, rx, ry = st[6], st[6 + n], st[6 + 1], st[6 + n + 1]
    c, s = torch.cos(st[6 + 2 * n + 1]), torch.sin(st[6 + 2 * n + 1])  # the receiver's heading
    ahead = 0.1115 + 0.02 + 0.13 * frac
    side = 0.1 * (frac - 0.5)
    pass_xy = (rx + ahead * c - side * s, ry + ahead * s + side * c, -1.5 * c, -1.5 * s)
    stop_xy = (0.5 * (sx + rx), 0.5 * (sy + ry), torch.zeros_like(sx), torch.zeros_like(sx))
    out_x = torch.maximum(sx, rx) + 0.05
    out_xy = (out_x, 0.5 * (sy + ry), torch.ones_like(sx), torch.zeros_like(sx))
    lat = 0.0372 + 0.0026 * frac  # inside the face's 0.04 half-width, never on it
    edge_xy = (rx + 0.1135 * c - lat * s, ry + 0.1135 * s + lat * c, -2.5 * c, -2.5 * s)
    for k, (bx, by, bvx, bvy) in enumerate((pass_xy, stop_xy, out_xy, edge_xy)):
        m = kind == k
        for row, v in zip((0, 1, 2, 3, 4, 5), (bx, by, torch.full_like(bx, 0.0215), bvx, bvy,
                                              torch.zeros_like(bx))):
            st[row] = torch.where(m, v, st[row])
    stopped_row = 7 + 6 * n
    st[stopped_row] = torch.where(kind == 1, 20.0, torch.where(kind >= 0, 0.0, st[stopped_row]))
    return st, kind


def check_kernel_vs_plain(task, rng_mode: str, batch: int = B):
    """A few steps, kernel and plain each on their own trajectory, for
    both step-limit settings and both obs variants.  VSS-v0 starts from a
    reset state with random actions; the SSL tasks start after WARM_STEPS
    kernel steps of their policy (the actions of the checked steps come
    from the kernel's obs and go to both), DR and PE from lanes rebuilt by
    ``task.prepare``, at ``batch`` envs.  Returns (max error, where it is,
    dones seen, ``task.events`` summed over the checked steps)."""
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.ops.philox import make_key

    worst, where, dones, events = 0.0, {}, 0, {}
    for max_steps in (None, 3):
        for emit_final in (False, True):
            env = make_env(task)
            if max_steps is not None:
                env.max_episode_steps = max_steps
            benv = BatchedEnv(env, batch, device="cuda", fused=True, fused_rng="kernel")
            key = make_key(11, device="cuda")
            st_k, obs = benv.reset(key)
            gen = torch.Generator(device="cuda").manual_seed(5)
            for _ in range(task.warm_steps):
                st_k, obs, *_ = benv.step(st_k, task.actions(obs, gen), key)
            kinds = None
            if task.prepare is not None:
                st_k, kinds = task.prepare(st_k)
            st_p = st_k.clone()
            key_p = key.clone()
            for t in range(N_CHECK_STEPS):
                act = task.actions(obs, gen)
                if rng_mode == "kernel":
                    got = task.wrapper(env, st_k, act, key=key, emit_final=emit_final)
                    rows = task.draw(env, key_p, batch)
                else:
                    rows = task.draw(env, key, batch)
                    got = task.wrapper(env, st_k, act, *rows, emit_final=emit_final)
                want = task.plain(env, st_p, act, *rows, emit_final)
                tag = (f"{task.name} B={batch} rng={rng_mode} max_steps={max_steps} "
                       f"final={emit_final} step={t}")
                err, at = compare_step(env.n_robots, got, want, tag)
                if err >= worst:
                    worst, where = err, at
                dones += int(((got[2][1] > 0.5) | (got[2][2] > 0.5)).sum())
                if task.events is not None:
                    for k, v in task.events(kinds, st_k, got, t).items():
                        events[k] = events.get(k, 0) + v
                st_k, st_p = got[0], want[0]
                obs = got[1][:env.obs_size]
            if rng_mode == "kernel" and not torch.equal(key, key_p):
                raise AssertionError(f"{task.name}: kernel and plain keys advanced differently")
    torch.cuda.synchronize()
    if dones == 0:
        raise AssertionError(f"{task.name} rng={rng_mode}: no auto-reset inside the checked window")
    missing = [k for k in task.need_events if not events.get(k)]
    if missing:
        raise AssertionError(f"{task.name} rng={rng_mode}: no {missing} inside the checked window: {events}")
    return worst, where, dones, events


def dr_events(kinds, st_before, got, t):
    """Gate crossings and completions (count 6 -> 7) of a DR step; on the
    first checked step, how many built lanes of each branch went its way."""
    aux = got[2]
    crossed, term = aux[0] > 0.5, aux[1] > 0.5
    ev = {"crossings": int(crossed.sum()),
          "completions": int((crossed & term & (st_before[6 + 6 * 5 + 1] == 6.0)).sum())}
    if t == 0:
        went = (crossed, crossed, crossed, term & ~crossed, crossed, term & crossed, term, term)
        ev.update({f"built_{name}": int(((kinds == k) & w).sum())
                   for k, (name, w) in enumerate(zip(DR_KINDS, went))})
    return ev


def pe_events(kinds, st_before, got, t):
    """Passes received (reward 1) and wrong balls (-1 + ball_grad) of a PE
    step; on the first checked step, the built stopped and out lanes that
    ended as wrong balls."""
    aux = got[2]
    term = aux[1] > 0.5
    wrong = term & (aux[0] < -0.2)
    ev = {"received": int((term & (aux[0] > 0.9)).sum()), "wrong_ball": int(wrong.sum())}
    if t == 0:
        ev.update({"built_stopped_wrong": int(((kinds == 1) & wrong).sum()),
                   "built_out_wrong": int(((kinds == 2) & wrong).sum())})
    return ev


def policy_like_actions(n_act: int, n_obs: int, seed: int = 99):
    """Actions a policy could give: a fixed random linear map of the obs
    through tanh, plus noise from ``gen``, clipped to [-1, 1] (every wheel
    moves, some saturate)."""
    w = torch.randn((n_act, n_obs), generator=torch.Generator(device="cpu").manual_seed(seed)).to("cuda")

    def actions(obs, gen):
        noise = torch.randn((n_act, obs.shape[-1]), generator=gen, device=obs.device)
        return torch.clamp(torch.tanh(1.5 * w @ obs) + 0.3 * noise, -1.0, 1.0)

    return actions


def check_physics_vs_plain(batch: int = B, env_kwargs=None, env_id: str = "VSS-v0", actions=None):
    """The VSS physics kernel on a ``fused_physics`` rollout of ``batch``
    envs of ``env_id`` (with ``env_kwargs``): at every step the kernel vs
    its plain version on that step's arrays, and the whole step (state,
    obs, reward, flags, info) vs the unfused env step fed the same noise,
    for both step-limit settings and both obs variants.  ``actions(obs,
    gen)``: the step's actions (uniform random by default).  Returns (max
    error, dones seen)."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp
    from rsoccer_tpu_torch.ops.philox import make_key

    worst, dones = 0.0, 0
    for max_steps in (None, 3):
        for final in (False, True):
            env = rt.make(env_id, **(env_kwargs or {}))
            if max_steps is not None:
                env.max_episode_steps = max_steps
            fused = BatchedEnv(env, batch, device="cuda", fused_physics=True)
            twin = BatchedEnv(env, batch, device="cuda")
            key = make_key(11, device="cuda")
            st_k, obs = fused.reset(key)
            st_p = st_k
            gen = torch.Generator(device="cuda").manual_seed(5)
            for t in range(N_CHECK_STEPS):
                if actions is None:
                    act = torch.rand((env.action_size, batch), generator=gen, device="cuda") * 2 - 1
                else:
                    act = actions(obs, gen)
                t_noise, r_noise = fused._draw(key)
                cmd, _ = env.pre_physics(st_k, act, t_noise)
                rb, bl = vp._stack(st_k.world)
                cmd = torch.stack([cmd.v_wheel0, cmd.v_wheel1])
                k_rb, k_bl = vp.vss_physics(env, rb, bl, cmd)
                p_rb, p_bl = vp.vss_physics_plain(env, rb, bl, cmd)
                tag = f"vss_physics {env_id} B={batch} max_steps={max_steps} final={final} step={t}"
                d_th = (torch.remainder(k_rb[2] - p_rb[2] + math.pi, 2 * math.pi) - math.pi).abs()
                errs = [max_err(k_rb[[0, 1, 3, 4, 5]], p_rb[[0, 1, 3, 4, 5]]), float(d_th.max()),
                        max_err(k_bl, p_bl)]
                if not max(errs) <= ATOL:
                    raise AssertionError(f"{tag}: kernel vs plain beyond {ATOL}: {errs}")
                step = fused.step_final_with_noise if final else fused.step_with_noise
                plain = twin.step_final_with_noise if final else twin.step_with_noise
                got, want = step(st_k, act, t_noise, r_noise), plain(st_p, act, t_noise, r_noise)
                n_obs = 2 if final else 1

                def as_step(out):
                    rew, term, trunc, info = out[1 + n_obs:]
                    aux = torch.stack([rew, term.float(), trunc.float()] + list(info.values()))
                    return vf.pack_vss_state(out[0]), torch.cat(out[1:1 + n_obs]), aux

                worst = max(worst, *errs, compare_step(env.n_robots, as_step(got), as_step(want), tag)[0])
                dones += int((got[-3] | got[-2]).sum())
                st_k, st_p, obs = got[0], want[0], got[1]
    torch.cuda.synchronize()
    if dones == 0:
        raise AssertionError(f"vss_physics {env_id} {env_kwargs}: no auto-reset inside the checked window")
    return worst, dones


def check_philox_words():
    """Raw device Philox words vs the torch Philox, bit for bit, at
    env_base 0 and at a shard's env_base (there also equal to those columns
    of an unsharded draw)."""
    from rsoccer_tpu_torch.ops.philox import make_key, philox_words
    from rsoccer_tpu_torch.ops.vss_full import _library

    lib = _library()
    key = make_key(0x1234_5678_9ABC, stream=3, device="cuda")
    key[2] = (1 << 32) + 7  # exercise both step words
    n_blk = 36
    n = 0
    for env_base in (0, B // 2):
        out = torch.empty((4 * n_blk, B), dtype=torch.int32, device="cuda")
        err = lib.philox_words(key.data_ptr(), out.data_ptr(), n_blk, env_base, B,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"philox_words launch failed: cudaError {err}")
        want = philox_words(key, 4 * n_blk, B, env_base=env_base)
        got = out.to(torch.int64) & 0xFFFFFFFF
        if not torch.equal(got, want) or not torch.equal(
                got, philox_words(key, 4 * n_blk, env_base + B)[:, env_base:]):
            raise AssertionError(
                f"Philox words at env_base {env_base} differ in {int((got != want).sum())} of {got.numel()}"
            )
        n += got.numel()
    return n


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


def _device_kernels(fn, n: int, match: str, table: str) -> dict:
    """{kernel name: [device us, launches]} over ``n`` calls of ``fn``
    (after one call unprofiled) through ``tools/_trace.profile``, which
    takes the window again where it saw no kernel matching ``match`` and
    leaves out a user annotation's range on the device; ``table`` names a
    file under chiprun_out/ for the top 40 kernels."""
    fn()
    torch.cuda.synchronize()
    trace = _trace.profile(fn, n, None, "cuda", match=match)
    if table:
        with open(os.path.join(OUT_DIR, table), "w") as fh:
            fh.write(trace.table(40))
    return trace.kernels


def _top(kernels: dict) -> dict:
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])
    return {k[:80]: v for k, v in top.items()}


def device_us(fn, n: int, match: str = "", table: str = "") -> tuple[float, dict]:
    """Device time per call of ``fn`` from the profiler over ``n`` calls:
    (us per call summed over the device kernels whose name the regular
    expression ``match`` finds, {kernel name: us per call} of the top
    kernels).  With a ``match``, each matched kernel is taken to launch
    once per call: its time per call is its time per launch the profiler
    saw (a window that misses events stays right)."""
    kernels = {k: us / (c if match else n) for k, (us, c) in _device_kernels(fn, n, match, table).items()
               if re.search(match, k)}
    total = sum(kernels.values())
    if total <= 0:
        raise RuntimeError(f"the profiler saw no device time for {match or 'any kernel'!r}")
    return total, _top(kernels)


def device_us_split(fn, n: int, match: str, table: str = "") -> tuple[float, float, dict]:
    """One profiled window for both of :func:`device_us`'s readings: (us
    per launch of the kernels ``match`` finds, us per call of all device
    kernels, the top kernels per call)."""
    events = _device_kernels(fn, n, match, table)
    matched = sum(us / c for k, (us, c) in events.items() if re.search(match, k))
    kernels = {k: us / n for k, (us, _) in events.items()}
    if matched <= 0 or not kernels:
        raise RuntimeError(f"the profiler saw no device time for {match!r}")
    return matched, sum(kernels.values()), _top(kernels)


def fused_calls(task, env, carry):
    """A fused step's kernel (kernel RNG and input rows) and plain calls on
    the main path's last state, with each call's operands for the bound."""
    from rsoccer_tpu_torch.ops.philox import make_key

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

    def n_done(outs):
        return int(((outs[2][1] > 0.5) | (outs[2][2] > 0.5)).sum())

    return dict(kernel=kernel_call, kernel_input=kernel_input_call, plain=plain_call,
                ins=(st, act, key), ins_input=(st, act, *rows), n_done=n_done)


def physics_calls(task, env, carry):
    """The VSS physics kernel and its plain version on the main path's last
    world (``carry.state``, structured), with the commands of one more
    step."""
    from rsoccer_tpu_torch.envs.base import draw_noise
    from rsoccer_tpu_torch.ops import vss_physics as vp
    from rsoccer_tpu_torch.ops.philox import make_key

    b = carry.state.steps.shape[-1]
    act = torch.rand((env.action_size, b), generator=torch.Generator(device="cuda").manual_seed(7),
                     device="cuda") * 2 - 1
    t_noise = draw_noise(make_key(3, device="cuda"), env.transition_noise_spec(), b)
    cmd, _ = env.pre_physics(carry.state, act, t_noise)
    cmd = torch.stack([cmd.v_wheel0, cmd.v_wheel1])
    rb, bl = vp._stack(carry.state.world)
    return dict(kernel=lambda: vp.vss_physics(env, rb, bl, cmd),
                plain=lambda: vp.vss_physics_plain(env, rb, bl, cmd),
                ins=(rb, bl, cmd), n_done=lambda outs: 0)


def time_at_scale(card, k1, k2, ssl_tasks):
    """Device time per launch of the VSS fused step (task ``k1``, both RNG
    modes), the physics kernel (task ``k2``) and the SSL steps of
    ``ssl_tasks`` (K4-K7, each in its RNG modes) at each of SCALE_BATCHES envs,
    on the state after 20 main-path steps, through the wrappers (so through
    each one's ``route``), with each call's bound; then the one-thread VSS
    kernels and SD's and DR's (:func:`thread_kernels_at`), and the share of
    SD's and DR's warps that hold a done env (:func:`done_shares`).  Four
    phases per batch."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp
    from rsoccer_tpu_torch.ops.philox import make_key

    probe = thread_probe_state()
    for batch in SCALE_BATCHES:
        env = rt.make("VSS-v0")
        benv = BatchedEnv(env, batch, device="cuda", fused=True, fused_rng="kernel")
        carry, _ = R.make_rollout_fn(benv, 20)(R.init_carry(benv, seed=0))
        st = carry.state
        gen = torch.Generator(device="cuda").manual_seed(7)
        act = torch.rand((2, batch), generator=gen, device="cuda") * 2 - 1
        key = make_key(3, device="cuda")
        rows = vf.draw_step_rows(env, key.clone(), batch)
        rb, bl = vp._stack(vf.unpack_vss_state(st, env.n_robots, env.field.rbt_wheel_radius).world)
        cmd = (torch.rand((2, env.n_robots, batch), generator=gen, device="cuda") * 2 - 1) * 60.0
        calls = {
            "vss_full_kernel_rng": (k1, lambda: vf.vss_full_step(env, st, act, key=key), (st, act, key)),
            "vss_full_input_rows": (k1, lambda: vf.vss_full_step(env, st, act, *rows), (st, act, *rows)),
            "vss_physics": (k2, lambda: vp.vss_physics(env, rb, bl, cmd), (rb, bl, cmd)),
        }
        ssl_ops = {}
        for task in ssl_tasks:
            s_env, s_st, s_act = ssl_state(task, batch)
            s_key = make_key(3, device="cuda")
            s_rows = task.draw(s_env, s_key.clone(), batch)
            ssl_ops[task.name] = (task, s_env, s_st, s_act, s_key, s_rows)
            calls[f"{task.name}_kernel_rng"] = (
                task, lambda t=task, e=s_env, x=s_st, a=s_act, k=s_key: t.wrapper(e, x, a, key=k), (s_st, s_act, s_key))
            if s_rows:
                calls[f"{task.name}_input_rows"] = (
                    task, lambda t=task, e=s_env, x=s_st, a=s_act, r=s_rows: t.wrapper(e, x, a, *r),
                    (s_st, s_act, *s_rows))
        dev_us, bound_us = {}, {}
        for name, (task, fn, ins) in calls.items():
            dev_us[name], _ = device_us(fn, TIMED_LAUNCHES, task.kernel_match)
            outs = fn()
            n_done = 0 if task is k2 else int(((outs[2][1] > 0.5) | (outs[2][2] > 0.5)).sum())
            bound, by, _, _ = bound_ms(ins, outs, task.ops_env, task.ops_reset, n_done)
            bound_us[name] = [bound * 1e3, by]
        torch.cuda.synchronize()
        phase("kernel_scale", card=card, B=batch, device_us=dev_us, bound_us=bound_us,
              vss_route={"vss_full": vf.route(env, batch), "vss_physics": vp.route(env, batch)})
        phase("kernel_scale_one_thread", card=card, B=batch, **thread_kernels_at(batch, probe, ssl_ops))
        for task, *_ in ssl_ops.values():  # how many warps of the one-thread SD and DR kernels reset
            if task.name in ("ssl_sd_full_step", "ssl_dr_full_step"):
                phase(f"done_share_{task.name}", card=card, B=batch, **done_shares(task, batch=batch))


# the one-thread VSS kernels that kernel_scale reports on: (K1 or K2, env kwargs)
SCALE_THREAD_KERNELS = {"k1_3v3": ("full", {}), "k1_5v5": ("full", VSS_CONFIGS["5v5"]),
                        "k2_n6": ("physics", {}), "k2_n10": ("physics", VSS_CONFIGS["5v5"])}


def thread_probe_state():
    """What kernel_scale reads once about this tree's one-thread kernels
    (VSS, SD, DR): registers, spills and static shared memory (``-Xptxas -v`` of
    the build), the static SASS per env (``cuobjdump``, tools/thread_probe)
    and the SM clock (``nvidia-smi``)."""
    from rsoccer_tpu_torch.ops import _build
    from rsoccer_tpu_torch.tools import thread_probe as tp

    path, log, _ = _build.build()
    return SimpleNamespace(regs=tp.thread_kernel_regs(tp.ptxas_kernels(log)), sass=tp.kernel_sass(path),
                           clocks=tp.sm_clocks())


def thread_kernels_at(batch, probe, ssl_ops=None) -> dict:
    """Each of SCALE_THREAD_KERNELS at ``batch`` envs through the one-thread
    C entry the wrapper's route names there (the capped variant for 10
    robots above ops/vss_full.THREAD_UNCAPPED_MAX_ENVS), kernel RNG, on the
    state after 20 steps, and SD's and DR's one-thread kernels on the
    operands of ``ssl_ops`` (task name -> (task, env, state, action, key,
    rows)): device us per launch, the bound, registers and spills,
    resident warps per SM, the static SASS per env and the issue floor
    (SASS per env x warps / (132 SMs x 4 schedulers x the SM clock))."""
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp
    from rsoccer_tpu_torch.tools import thread_probe as tp

    lib, res, operands = vf._library(), {}, {}
    for tag, (kind, kwargs) in SCALE_THREAD_KERNELS.items():
        key_ = tuple(sorted(kwargs.items()))
        if key_ not in operands:  # K1 and K2 of a team size on the same state
            operands[key_] = vss_operands(batch, **kwargs)
        env, st, act, key, rows, rb, bl, cmd = operands[key_]
        n, wrapper = env.n_robots, vf if kind == "full" else vp
        capped = n in wrapper.THREAD_CAPPED_ROBOTS and batch > wrapper.THREAD_UNCAPPED_MAX_ENVS
        suffix = "_capped" if capped else ""
        if kind == "full":
            entry = "vss_full_step_one_thread" + suffix
            outs = vss_outs(env, batch)
            fn = lambda e=entry, env=env, st=st, act=act, key=key, rows=rows, o=outs: vss_entry_call(  # noqa: E731
                lib, e, env, st, act, rows, key, o)
            ins, (ops_env, ops_reset) = (st, act, key), vss_full_ops(n)
        else:
            entry = "vss_physics_step_one_thread" + suffix
            outs = (torch.empty_like(rb), torch.empty_like(bl))
            fn = lambda e=entry, env=env, rb=rb, bl=bl, cmd=cmd, o=outs: vss_physics_entry_call(  # noqa: E731
                lib, e, env, rb, bl, cmd, o)
            ins, ops_env, ops_reset = (rb, bl, cmd), vss_physics_ops(n), 0
        routed = wrapper.routed_entry(env, batch)
        if routed != entry and wrapper.route(env, batch) == "thread":
            raise AssertionError(f"{tag} at {batch} envs: the route names {routed}, not {entry}")
        us, top = device_us(fn, TIMED_LAUNCHES, "thread_kernel")
        label = next(lab for lab in map(tp.label_of_demangled, top) if lab)  # the kernel the entry launched
        fn()
        n_done = int(((outs[2][1] > 0.5) | (outs[2][2] > 0.5)).sum()) if kind == "full" else 0
        bound, by, _, _ = bound_ms(ins, outs, ops_env, ops_reset, n_done)
        r, per_env = probe.regs[label], probe.sass[label]["per_env"]
        res[tag] = dict(entry=entry, kernel=label, device_us=us, bound_us=bound * 1e3, bound_by=by,
                        registers=r["registers"], spill_bytes=r["spill_bytes"],
                        warps_per_sm=tp.warps_per_sm(r["registers"], vf.THREAD_BLOCK, r["smem"]),
                        sass_per_env=per_env,
                        issue_floor_us=tp.issue_floor_us(per_env, batch, probe.clocks["clocks_max_sm_mhz"]))
    for name, (task, env, st, act, key, rows) in (ssl_ops or {}).items():
        if name not in sf.GROUP_ENTRIES:  # CP and PE have one kernel: kernel_scale times it
            continue
        entry = name + "_one_thread"
        if sf.routed_entry(task.entry, batch) != entry:
            raise AssertionError(f"{name} at {batch} envs: the route names {sf.routed_entry(task.entry, batch)}")
        outs = (torch.empty_like(st), torch.empty((env.obs_size, batch), device="cuda"),
                torch.empty((3 + (len(sf.SD_KEYS) if rows else 0), batch), device="cuda"))
        fn = lambda e=entry, env=env, st=st, act=act, rows=rows, key=key, o=outs: ssl_entry_call(  # noqa: E731
            sf._library(), e, env, st, act, rows, key, False, o)
        us, top = device_us(fn, TIMED_LAUNCHES, "thread_kernel")
        label = next(lab for lab in map(tp.label_of_demangled, top) if lab)
        fn()
        n_done = int(((outs[2][1] > 0.5) | (outs[2][2] > 0.5)).sum())
        bound, by, _, _ = bound_ms((st, act, key), outs, task.ops_env, task.ops_reset, n_done)
        r, per_env = probe.regs[label], probe.sass[label]["per_env"]
        res[name] = dict(entry=entry, kernel=label, device_us=us, bound_us=bound * 1e3, bound_by=by,
                         registers=r["registers"], spill_bytes=r["spill_bytes"], smem_bytes=r["smem"],
                         warps_per_sm=tp.warps_per_sm(r["registers"], sf.THREAD_BLOCK, r["smem"]),
                         sass_per_env=per_env,
                         issue_floor_us=tp.issue_floor_us(per_env, batch, probe.clocks["clocks_max_sm_mhz"]))
    torch.cuda.synchronize()
    return {"one_thread": res, "clocks": probe.clocks}


def build_baseline(csrc_dir):
    """nvcc the kernels of another tree's ``csrc_dir`` (the same flags as
    this tree's, one nvcc per source, all at once) into a library under
    OUT_DIR; ctypes-loaded, entries declared, its parameter structs checked
    against this tree's."""
    import ctypes
    import shutil

    from rsoccer_tpu_torch.ops import _build
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops import vss_full as vf

    out = os.path.join(OUT_DIR, "baseline")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc_dir, out)
    nvcc = _build.nvcc_path()
    names = sorted(f[:-3] for f in os.listdir(out) if f.endswith(".cu"))
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", f"{out}/{n}.o", f"{out}/{n}.cu"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for n in names]
    logs = [(pr.communicate()[0], pr.returncode) for pr in procs]
    if any(rc for _, rc in logs):
        raise RuntimeError("baseline nvcc failed:\n" + "".join(log for log, _ in logs))
    subprocess.run([nvcc, "-shared", "-o", f"{out}/lib.so", *(f"{out}/{n}.o" for n in names)], check=True)
    lib = ctypes.CDLL(f"{out}/lib.so")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vss_params_fields.restype = ctypes.c_char_p
    lib.ssl_params_fields.restype = ctypes.c_char_p
    # a tree before the one-thread VSS kernels: no exact_trig argument
    n_int = 5 if hasattr(lib, "vss_full_step_one_thread") else 4
    base = [i] if takes_env_base(lib) else []
    lib.vss_full_step.argtypes = [i] * n_int + [p] * 10 + base + [i, p]
    lib.vss_physics_step.argtypes = [p] * 6 + [i, i, p]
    if hasattr(lib, "vss_full_step_one_thread"):  # the same arguments as the group entries
        lib.vss_full_step_one_thread.argtypes = lib.vss_full_step.argtypes
        lib.vss_physics_step_one_thread.argtypes = lib.vss_physics_step.argtypes
    for entry, n_ptr in SSL_ENTRIES.values():
        drawn = base if entry != "ssl_dr_full_step" else []
        getattr(lib, entry).argtypes = [i, i] + [p] * n_ptr + drawn + [i, p]
        if entry in sf.GROUP_ENTRIES and hasattr(lib, entry + "_one_thread"):  # the same arguments
            getattr(lib, entry + "_one_thread").argtypes = getattr(lib, entry).argtypes
    if lib.vss_params_fields().decode().rstrip(",").split(",") != vf.PARAM_FIELDS:
        raise RuntimeError("the baseline's VssParams differ from this tree's")
    if lib.ssl_params_fields().decode().rstrip(",").split(",") != sf.PARAM_FIELDS:
        raise RuntimeError("the baseline's SslParams differ from this tree's")
    ptxas = [ln.strip() for log, _ in logs for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return lib, ptxas


def takes_env_base(lib) -> bool:
    """Whether the C entries of ``lib`` that draw take an ``env_base``
    argument before B: trees whose library exports
    ``kernels_abi_version`` (>= 1); a library of an older tree does not."""
    return hasattr(lib, "kernels_abi_version") and lib.kernels_abi_version() >= 1


# SSL task -> (C entry, pointer arguments of the entry)
SSL_ENTRIES = {
    "ssl_sd_full_step": ("ssl_sd_full_step", 10),
    "ssl_cp_full_step": ("ssl_cp_full_step", 8),
    "ssl_dr_full_step": ("ssl_dr_full_step", 6),
    "ssl_pe_full_step": ("ssl_pe_full_step", 9),
}
# the SD and DR crossover's batches; up to MAIN_STATE_MAX_B also on the main
# path's state (DR's one-thread kernel wins there at 8192: the lower batches
# find its own crossover)
CROSSOVER_BATCHES = (4096, 6144, 7168, B, 8448, 10240, 16384, 32768, 131072)
MAIN_STATE_MAX_B = 16384


def ssl_entry_call(lib, entry, env, st, act, rows, key, emit_final, outs, env_base=0):
    """Launch the C entry ``entry`` of ``lib`` (an SSL fused step) on the
    given operands into ``outs``, as ``ops/ssl_full._launch`` does, without
    advancing the key (``env_base`` where the library takes one)."""
    import ctypes

    from rsoccer_tpu_torch.ops import ssl_full as sf

    rng = key is not None
    ptrs = [None if rng else r.data_ptr() for r in rows]
    base = ()
    if rows:
        ptrs.append(key.data_ptr() if rng else None)
        base = (env_base,) if takes_env_base(lib) else ()
    err = getattr(lib, entry)(int(emit_final), int(rng), ctypes.byref(sf._params_struct(env)), st.data_ptr(),
                              act.data_ptr(), *ptrs, *(t.data_ptr() for t in outs), *base, st.shape[-1],
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def ssl_state(task, batch, steps: int = 20, prepare: bool = True):
    """The task's state after ``steps`` main-path steps at ``batch`` envs
    (DR and PE with the lanes of ``task.prepare`` unless ``prepare`` is
    false), its obs and one step's actions."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv

    env = rt.make(task.env_id)
    benv = BatchedEnv(env, batch, device="cuda", fused=True, fused_rng="kernel")
    carry, _ = R.make_rollout_fn(benv, steps)(R.init_carry(benv, seed=0))
    st = carry.state
    if prepare and task.prepare is not None:
        st, _ = task.prepare(st)
    act = task.actions(carry.obs, torch.Generator(device="cuda").manual_seed(7))
    return env, st.contiguous(), act.contiguous()


def ssl_against_baseline(lib, tasks, card):
    """This tree's SSL steps (K4-K7) against the baseline library's.  First
    the one-thread SD and DR entries bit for bit (tools/thread_probe's
    ``check_ssl_bits``: both RNG modes, both obs variants, SD at env_base 0
    and 4096) at each of its ``SSL_BITS_BATCHES``, on the states of
    :func:`ssl_state` (SD under its chase actions, DR with its gate lanes).
    Then at each of CROSSOVER_BATCHES:
    every step through its wrapper (the route's kernel) bit for bit against
    the baseline's C entry (SD's and DR's group kernels) in both RNG modes
    and both obs variants; each step's C entry (K4, K5 and K7 in both RNG
    modes) timed in turns (baseline, this tree's, the same, baseline), and
    SD's and DR's one-thread entries the same way beside them, on the
    20-step state and, up to MAIN_STATE_MAX_B, on the main path's
    (``_main_state``); the route at each batch beside the design that
    measured faster, and the routed kernel's time over the baseline's same
    entry and over the baseline's faster design.  One phase per batch.
    Raises if an output differs."""
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops.philox import make_key
    from rsoccer_tpu_torch.tools import thread_probe as tp

    this = sf._library()
    if hasattr(lib, "ssl_sd_full_step_one_thread") and takes_env_base(lib):  # the probe passes env_base
        task_of_kind = {kind: next(t for t in tasks if t.env_id == env_id) for kind, env_id in tp.SSL_ENV_IDS.items()}
        for batch in tp.SSL_BITS_BATCHES:
            n = tp.check_ssl_bits(this, lib, (batch,), state=lambda kind, b: ssl_state(task_of_kind[kind], b)[1:])
            phase("ssl_thread_baseline_bits", card=card, B=batch, comparisons=n)
    for batch in CROSSOVER_BATCHES:
        turns, thread_turns, task_of = {}, {}, {}
        for task in tasks:
            entry, _ = SSL_ENTRIES[task.name]
            env, st, act = ssl_state(task, batch)
            key = make_key(3, device="cuda")
            rows = task.draw(env, key.clone(), batch)
            for rng in (False, True):
                for emit_final in (False, True):
                    k0 = key.clone()
                    got = task.wrapper(env, st, act, *(() if rng else rows),
                                       **({"key": key} if rng else {}), emit_final=emit_final)
                    key.copy_(k0)
                    base = tuple(torch.full_like(t, float("nan")) for t in got)
                    ssl_entry_call(lib, entry, env, st, act, rows, key if rng else None, emit_final, base)
                    if not bit_equal(got, base):
                        raise AssertionError(f"{task.name} at {batch} envs (rng_kernel={rng}, "
                                             f"final={emit_final}): outputs differ from the baseline's")
            outs = tuple(torch.empty_like(t) for t in got[:1]) + (
                torch.empty((env.obs_size, batch), device="cuda"), torch.empty_like(got[2]))
            modes = {"kernel_rng": True, "input_rows": False} if rows else {"kernel_rng": True}
            states = {"": (st, act)}
            if batch <= MAIN_STATE_MAX_B:  # and the main path's state: 700 steps, as main_path times it
                _, m_st, m_act = ssl_state(task, batch, 2 * ROLLOUT_STEPS + TIMED_ROLLOUTS * ROLLOUT_STEPS,
                                           prepare=False)
                states["_main_state"] = (m_st, m_act)
            for tag, (x, a) in states.items():
                for mode, rng in modes.items():
                    def run(lib_, ent, rng=rng, x=x, a=a):
                        return lambda: ssl_entry_call(lib_, ent, env, x, a, rows, key if rng else None, False, outs)
                    name = f"{task.name}_{mode}{tag}"
                    task_of[name] = task.name
                    entries = [entry] + ([entry + "_one_thread"] if entry in sf.GROUP_ENTRIES else [])
                    for ent, table in zip(entries, (turns, thread_turns)):
                        base_fn, this_fn = run(lib, ent), run(this, ent)
                        table[name] = [device_us(fn, TIMED_LAUNCHES, task.kernel_match)[0]
                                       for fn in (base_fn, this_fn, this_fn, base_fn)]

        def means(table):
            return {n: {"baseline": (t[0] + t[3]) / 2, "this": (t[1] + t[2]) / 2} for n, t in table.items()}

        mean_us, thread_us = means(turns), means(thread_turns)
        route = {t.name: sf.route(t.name, batch) for t in tasks}
        routed = {n: (thread_us if n in thread_us and route[task_of[n]] == "thread" else mean_us)[n] for n in mean_us}
        # the baseline's faster design at this batch, whatever its route was
        best = {n: min(v["baseline"], thread_us.get(n, v)["baseline"]) for n, v in mean_us.items()}
        phase("ssl_baseline_turns", card=card, B=batch, bit_equal=[t.name for t in tasks],
              baseline_this_this_baseline_us=turns, one_thread_baseline_this_this_baseline_us=thread_turns,
              mean_us=mean_us, one_thread_mean_us=thread_us, route=route, routed_mean_us=routed,
              routed_this_over_baseline={n: v["this"] / v["baseline"] for n, v in routed.items()},
              routed_this_over_baseline_best={n: v["this"] / best[n] for n, v in routed.items()},
              faster={n: "group" if mean_us[n]["this"] <= v["this"] else "thread" for n, v in thread_us.items()})


def routed_entry(task, batch: int) -> str:
    """The C entry that ``task``'s wrapper launches at ``batch`` envs, by
    the wrapper's route: the SSL steps by their C entry, the VSS steps and
    the physics kernel by the env's team size."""
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp

    if task.name in SSL_ENTRIES:
        return sf.routed_entry(task.entry, batch)
    return (vf if task.wrapper is vf.vss_full_step else vp).routed_entry(make_env(task), batch)


def done_shares(task, steps: int = ROLLOUT_STEPS, batch: int = B) -> dict:
    """The share of envs, and of 32-env warps, that hold a done env per
    step of the task's main path at ``batch`` envs (uniform random policy,
    after 2 * ``steps`` warm-up steps): how often a warp of a one-thread
    kernel (32 envs) runs a reset, where one done env makes the whole warp
    wait for it (the SD one-thread kernel spreads its reset over the
    warp)."""
    from rsoccer_tpu_torch.batch.rollout import init_carry
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.tools import thread_probe as tp

    env = make_env(task)
    benv = task.make_benv(env) if batch == B else BatchedEnv(env, batch, device="cuda", fused=True,
                                                              fused_rng="kernel")
    carry = init_carry(benv, seed=0)
    st, key = carry.state, carry.key
    gen = torch.Generator(device="cuda").manual_seed(9)
    dones = []
    for t in range(3 * steps):
        act = torch.rand((env.action_size, batch), generator=gen, device="cuda") * 2 - 1
        st, _, _, term, trunc, _ = benv.step(st, act, key)
        if t >= 2 * steps:
            dones.append(term | trunc)
    d = torch.stack(dones)  # (steps, batch)
    share = {"envs": d.float().mean(1), "warps": tp.warp_done_share(d)}
    return {"steps": steps, **{f"{k}_mean": float(v.mean()) for k, v in share.items()},
            **{f"{k}_max": float(v.max()) for k, v in share.items()}}


def vss_entry_call(lib, entry, env, st, act, rows, key, outs, emit_final=False, env_base=0):
    """Launch the C entry ``entry`` of ``lib`` (a VSS fused step) on the
    given operands into ``outs``, without advancing the key.  A library
    built from a tree before the one-thread VSS kernels (no
    ``vss_full_step_one_thread``) takes no ``exact_trig`` argument, one
    before ``env_base`` (:func:`takes_env_base`) no ``env_base``."""
    import ctypes

    from rsoccer_tpu_torch.ops import vss_full as vf

    rng = key is not None
    ou, sp, th = (None, None, None) if rng else (r.data_ptr() for r in rows)
    trig = (int(not vf.taylor_rotation_holds(env)),) if hasattr(lib, "vss_full_step_one_thread") else ()
    base = (env_base,) if takes_env_base(lib) else ()
    err = getattr(lib, entry)(env.n_blue, env.n_yellow, int(emit_final), int(rng), *trig,
                              ctypes.byref(vf._params_struct(env)), st.data_ptr(), act.data_ptr(), ou, sp, th,
                              key.data_ptr() if rng else None, *(t.data_ptr() for t in outs), *base,
                              st.shape[-1], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def vss_physics_entry_call(lib, entry, env, rb, bl, cmd, outs):
    """Launch the C entry ``entry`` of ``lib`` (a VSS physics step)."""
    import ctypes

    from rsoccer_tpu_torch.ops import vss_physics as vp

    err = getattr(lib, entry)(ctypes.byref(vp._params_struct(env)), rb.data_ptr(), bl.data_ptr(), cmd.data_ptr(),
                              *(t.data_ptr() for t in outs), env.n_robots, rb.shape[-1],
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def bit_equal(got, want) -> bool:
    """Every output equal bit for bit (a -0 against a +0 counts)."""
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))


def vss_operands(batch, **env_kwargs):
    """VSS-v0 (with ``env_kwargs``) after 20 main-path steps at ``batch``
    envs: (env, packed state, actions, key, the key's noise rows, robots,
    ball, wheel commands)."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp
    from rsoccer_tpu_torch.ops.philox import make_key

    benv = rt.make_vec("VSS-v0", batch, device="cuda", fused=True, fused_rng="kernel", **env_kwargs)
    env = benv.env
    carry, _ = R.make_rollout_fn(benv, 20)(R.init_carry(benv, seed=0))
    st = carry.state
    gen = torch.Generator(device="cuda").manual_seed(7)
    act = torch.rand((2, batch), generator=gen, device="cuda") * 2 - 1
    key = make_key(3, device="cuda")
    rows = vf.draw_step_rows(env, key.clone(), batch)
    rb, bl = vp._stack(vf.unpack_vss_state(st, env.n_robots, env.field.rbt_wheel_radius).world)
    cmd = (torch.rand((2, env.n_robots, batch), generator=gen, device="cuda") * 2 - 1) * 60.0
    return env, st, act, key, rows, rb, bl, cmd


def vss_outs(env, batch, emit_final=False):
    """NaN-filled outputs of a VSS fused step (state, obs, aux)."""
    from rsoccer_tpu_torch.ops import vss_full as vf

    return (torch.full((vf.state_size(env.n_robots), batch), float("nan"), device="cuda"),
            torch.full((env.obs_size * (2 if emit_final else 1), batch), float("nan"), device="cuda"),
            torch.full((vf.N_AUX, batch), float("nan"), device="cuda"))


def check_thread_vs_group(batch: int = VSS_THREAD_B):
    """At 3v3 and 5v5 the one-thread VSS kernels (at 5v5 also their capped
    variants) against the group kernels (8 lanes at 3v3, 16 at 5v5),
    through their C entries on the same operands: K1 in both RNG modes, both obs variants and both trig
    policies (the Taylor rotation at the default time step, exact trig at
    0.1 s), K2 (N = 6 and 10); every output bit for bit.  Returns the number
    of comparisons by team size."""
    from rsoccer_tpu_torch.ops import vss_full as vf

    lib = vf._library()
    n_cmp = {"3v3": 0, "5v5": 0}
    for team, kwargs in (("3v3", {}), ("3v3", VSS_CONFIGS["3v3_dt0.1"]), ("5v5", VSS_CONFIGS["5v5"]),
                         ("5v5", VSS_5V5_EXACT)):
        env, st, act, key, rows, rb, bl, cmd = vss_operands(batch, **kwargs)
        for rng in (False, True):
            for emit_final in (False, True):
                outs = {}
                for entry in ("vss_full_step", "vss_full_step_one_thread") + (
                        ("vss_full_step_one_thread_capped",) if env.n_robots in vf.THREAD_CAPPED_ROBOTS else ()):
                    outs[entry] = vss_outs(env, batch, emit_final)
                    vss_entry_call(lib, entry, env, st, act, rows, key if rng else None, outs[entry], emit_final)
                if not all(bit_equal(outs["vss_full_step"], o) for o in outs.values()):
                    raise AssertionError(f"vss_full_step one-thread vs group kernel at {batch} envs {kwargs} "
                                         f"(rng_kernel={rng}, final={emit_final}): outputs differ")
                n_cmp[team] += 1
        if "time_step" not in kwargs:
            outs = {}
            for entry in ("vss_physics_step", "vss_physics_step_one_thread") + (
                    ("vss_physics_step_one_thread_capped",) if env.n_robots in vf.THREAD_CAPPED_ROBOTS else ()):
                outs[entry] = (torch.full_like(rb, float("nan")), torch.full_like(bl, float("nan")))
                vss_physics_entry_call(lib, entry, env, rb, bl, cmd, outs[entry])
            if not all(bit_equal(outs["vss_physics_step"], o) for o in outs.values()):
                raise AssertionError(f"vss_physics one-thread vs group kernel at {batch} envs, "
                                     f"N = {env.n_robots}: outputs differ")
            n_cmp[team] += 1
    torch.cuda.synchronize()
    return n_cmp


# team size -> env kwargs of the one-thread kernels' bit-for-bit checks
# against the baseline's (5v5 in the 5v5 pass); each also beyond the
# Taylor bound (time_step 0.1)
THREAD_TEAMS = {"1v0": VSS_CONFIGS["1v0"], "2v2": dict(n_robots_blue=2, n_robots_yellow=2), "3v3": {}}
# the batches of those checks: a ragged one (B % 4 != 0, the last 64-env
# block part empty), the first one-thread batch at 5v5 (ragged too), the
# crossover batches
THREAD_BASELINE_BATCHES = (RAGGED_B, 16385, *VSS_CROSSOVER_BATCHES)
THREAD_ENV_BASES = (0, 4096)


def thread_bits_against_baseline(lib, batch, teams) -> int:
    """This tree's one-thread VSS kernels (and, for 7-10 robots, their
    capped variants) against the baseline library's on the same operands,
    every output bit for bit: K1 for each env kwargs of ``teams`` in both
    RNG modes, both obs variants and ``env_base`` 0 and 4096 (the input rows
    drawn there); K2 at each robot count (default time step).  Returns the number of comparisons; raises on a difference."""
    from rsoccer_tpu_torch.ops import vss_full as vf

    this, n = vf._library(), 0
    for kwargs in teams:
        env, st, act, key, rows, rb, bl, cmd = vss_operands(batch, **kwargs)
        rows_at = {base: vf.draw_step_rows(env, key.clone(), batch, base) for base in THREAD_ENV_BASES}
        runs = [(lib, "vss_full_step_one_thread"), (this, "vss_full_step_one_thread")] + (
            [(this, "vss_full_step_one_thread_capped")] if env.n_robots in vf.THREAD_CAPPED_ROBOTS else [])
        for rng in (False, True):
            for emit_final in (False, True):
                for base in THREAD_ENV_BASES:
                    got = [vss_outs(env, batch, emit_final) for _ in runs]
                    for (lib_, entry), o in zip(runs, got):
                        vss_entry_call(lib_, entry, env, st, act, rows_at[base], key if rng else None, o,
                                       emit_final, base)
                    if not all(bit_equal(got[0], g) for g in got[1:]):
                        raise AssertionError(f"vss_full_step_one_thread at {batch} envs {kwargs} (rng_kernel={rng}, "
                                             f"final={emit_final}, env_base={base}): outputs differ from the "
                                             "baseline's")
                    n += 1
        if "time_step" not in kwargs:
            runs = [(lib, "vss_physics_step_one_thread"), (this, "vss_physics_step_one_thread")] + (
                [(this, "vss_physics_step_one_thread_capped")] if env.n_robots in vf.THREAD_CAPPED_ROBOTS else [])
            got = [(torch.full_like(rb, float("nan")), torch.full_like(bl, float("nan"))) for _ in runs]
            for (lib_, entry), o in zip(runs, got):
                vss_physics_entry_call(lib_, entry, env, rb, bl, cmd, o)
            if not all(bit_equal(got[0], g) for g in got[1:]):
                raise AssertionError(f"vss_physics_step_one_thread at N = {env.n_robots}, {batch} envs: outputs "
                                     "differ from the baseline's")
            n += 1
    torch.cuda.synchronize()
    return n


def vss_against_baseline(lib, card):
    """At each of THREAD_BASELINE_BATCHES: this tree's one-thread VSS
    kernels bit for bit against the baseline library's at 1v0, 2v2 and 3v3,
    each at the default time step and at 0.1 s (K1 in both RNG modes, both
    obs variants, ``env_base`` 0 and 4096; K2 at N = 1, 4, 6), and, where
    the baseline has no one-thread kernels, this tree's 3v3 group kernels
    against its group kernels.  Then, at each of VSS_CROSSOVER_BATCHES,
    device us per launch in turns on the state after 20 VSS-v0 steps: at
    3v3 (K1 in both RNG modes, K2 at N = 6) the baseline's one-thread
    kernel, this tree's group kernel, its one-thread kernel, the same, the
    group kernel, the baseline's (the crossover, the route beside the
    faster design); at 1v0 (K1 both RNG modes, K2 at N = 1) the baseline's
    one-thread kernel, this tree's, the same, the baseline's.  The group
    kernels are also held bit for bit to the baseline's at 3v3.  One phase
    per batch.  Raises if an output differs."""
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp

    this = vf._library()
    one_thread = hasattr(lib, "vss_full_step_one_thread")  # a baseline with the one-thread VSS kernels
    base_thread = "vss_full_step_one_thread" if one_thread else "vss_full_step"
    base_phys = "vss_physics_step_one_thread" if one_thread else "vss_physics_step"
    teams = [dict(kw, **ts) for kw in THREAD_TEAMS.values() for ts in ({}, dict(time_step=0.1))]
    for batch in THREAD_BASELINE_BATCHES:
        n_cmp = thread_bits_against_baseline(lib, batch, teams) if one_thread else 0
        if batch not in VSS_CROSSOVER_BATCHES:
            phase("vss_baseline_bits", card=card, B=batch, bit_equal=True, comparisons=n_cmp)
            continue
        turns, route = {}, {}
        for team in ("3v3", "1v0") if one_thread else ("3v3",):
            env, st, act, key, rows, rb, bl, cmd = vss_operands(batch, **THREAD_TEAMS[team])
            outs = vss_outs(env, batch)
            phys_outs = (torch.empty_like(rb), torch.empty_like(bl))

            def full(lib_, entry, rng, env=env, st=st, act=act, key=key, rows=rows, outs=outs):
                return lambda: vss_entry_call(lib_, entry, env, st, act, rows, key if rng else None, outs)

            def phys(lib_, entry, env=env, rb=rb, bl=bl, cmd=cmd, o=phys_outs):
                return lambda: vss_physics_entry_call(lib_, entry, env, rb, bl, cmd, o)

            kernels = {  # name: (baseline one thread, baseline group, group, one thread, kernel names, outputs)
                f"{team}_vss_full_kernel_rng": (
                    full(lib, base_thread, True), full(lib, "vss_full_step", True), full(this, "vss_full_step", True),
                    full(this, "vss_full_step_one_thread", True), r"vss_(full|thread)_kernel", outs),
                f"{team}_vss_full_input_rows": (
                    full(lib, base_thread, False), full(lib, "vss_full_step", False),
                    full(this, "vss_full_step", False), full(this, "vss_full_step_one_thread", False),
                    r"vss_(full|thread)_kernel", outs),
                f"{team}_vss_physics": (
                    phys(lib, base_phys), phys(lib, "vss_physics_step"), phys(this, "vss_physics_step"),
                    phys(this, "vss_physics_step_one_thread"), r"vss_physics_(thread_)?kernel", phys_outs),
            }
            for name, (base, base_group, group, thread, match, o) in kernels.items():
                if team == "1v0":  # no group kernel
                    turns[name] = [device_us(fn, TIMED_LAUNCHES, match)[0] for fn in (base, thread, thread, base)]
                    continue
                got = []
                for fn in (base_group, group, thread):
                    fn()
                    got.append(tuple(t.clone() for t in o))
                if not (bit_equal(got[1], got[0]) and bit_equal(got[2], got[1])):
                    raise AssertionError(f"{name} at {batch} envs: the baseline's group, this tree's group and "
                                         "one-thread outputs differ")
                turns[name] = [device_us(fn, TIMED_LAUNCHES, match)[0]
                               for fn in (base, group, thread, thread, group, base)]
            route[team] = {"vss_full": vf.route(env, batch), "vss_physics": vp.route(env, batch)}
        mean_us = {n: ({"baseline_thread": (t[0] + t[5]) / 2, "group": (t[1] + t[4]) / 2, "thread": (t[2] + t[3]) / 2}
                       if len(t) == 6 else {"baseline_thread": (t[0] + t[3]) / 2, "thread": (t[1] + t[2]) / 2})
                   for n, t in turns.items()}
        phase("vss_baseline_turns", card=card, B=batch, bit_equal=True, comparisons=n_cmp,
              baseline_turns_us=turns, mean_us=mean_us, route=route,
              faster={n: "group" if m["group"] <= m["thread"] else "thread" for n, m in mean_us.items()
                      if "group" in m},
              thread_vs_baseline={n: m["thread"] / m["baseline_thread"] for n, m in mean_us.items()})


def vss_5v5_against_baseline(lib, card):
    """At each of THREAD_BASELINE_BATCHES: this tree's 16-lane group
    kernels (K1 at 5v5, K2 at N = 10) against its one-thread kernels, and
    those against the baseline library's one-thread kernels, every output
    bit for bit: K1 in both RNG modes, both obs variants and both trig
    policies (5v5 at the default time step and at 0.1 s), ``env_base`` 0
    and 4096 (one thread), K2 on the commands of :func:`vss_operands`.
    Then, at each of VSS_CROSSOVER_BATCHES, device us per launch of each
    in turns (baseline one thread, group, one thread, capped one thread,
    the same three backwards, baseline one thread) on the state after 20
    5v5 steps: the 5v5 crossovers (group, one thread, capped), with the
    routed entry beside the fastest design.  One phase per
    batch.  Raises if an output differs."""
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp

    this = vf._library()
    trio = ((this, "vss_full_step"), (this, "vss_full_step_one_thread"), (lib, "vss_full_step_one_thread"))
    phys_trio = ((this, "vss_physics_step"), (this, "vss_physics_step_one_thread"),
                 (lib, "vss_physics_step_one_thread"))
    for batch in THREAD_BASELINE_BATCHES:
        n_cmp = thread_bits_against_baseline(lib, batch, (VSS_5V5_EXACT, VSS_CONFIGS["5v5"]))
        for kwargs in (VSS_5V5_EXACT, VSS_CONFIGS["5v5"]):  # the timed operands last
            env, st, act, key, rows, rb, bl, cmd = vss_operands(batch, **kwargs)
            for rng in (False, True):
                for emit_final in (False, True):
                    got = [vss_outs(env, batch, emit_final) for _ in trio]
                    for (lib_, entry), o in zip(trio, got):
                        vss_entry_call(lib_, entry, env, st, act, rows, key if rng else None, o, emit_final)
                    if not (bit_equal(got[0], got[1]) and bit_equal(got[0], got[2])):
                        raise AssertionError(f"vss_full_step at 5v5, {batch} envs {kwargs} (rng_kernel={rng}, "
                                             f"final={emit_final}): the group, one-thread and baseline outputs differ")
                    n_cmp += 1
        got = [(torch.full_like(rb, float("nan")), torch.full_like(bl, float("nan"))) for _ in phys_trio]
        for (lib_, entry), o in zip(phys_trio, got):
            vss_physics_entry_call(lib_, entry, env, rb, bl, cmd, o)
        if not (bit_equal(got[0], got[1]) and bit_equal(got[0], got[2])):
            raise AssertionError(f"vss_physics at N = 10, {batch} envs: the group, one-thread and baseline "
                                 "outputs differ")
        n_cmp += 1
        if batch not in VSS_CROSSOVER_BATCHES:
            phase("vss_5v5_baseline_bits", card=card, B=batch, bit_equal=True, comparisons=n_cmp)
            continue
        outs, phys_outs = vss_outs(env, batch), got[0]

        def full(lib_, entry, rng):
            return lambda: vss_entry_call(lib_, entry, env, st, act, rows, key if rng else None, outs)

        def phys(lib_, entry):
            return lambda: vss_physics_entry_call(lib_, entry, env, rb, bl, cmd, phys_outs)

        kernels = {  # name: (baseline one thread, group, one thread, capped one thread, device kernel names)
            "vss_full_kernel_rng": (full(lib, "vss_full_step_one_thread", True), full(this, "vss_full_step", True),
                                    full(this, "vss_full_step_one_thread", True),
                                    full(this, "vss_full_step_one_thread_capped", True), r"vss_(full|thread)_kernel"),
            "vss_full_input_rows": (full(lib, "vss_full_step_one_thread", False),
                                    full(this, "vss_full_step", False),
                                    full(this, "vss_full_step_one_thread", False),
                                    full(this, "vss_full_step_one_thread_capped", False), r"vss_(full|thread)_kernel"),
            "vss_physics": (phys(lib, "vss_physics_step_one_thread"), phys(this, "vss_physics_step"),
                            phys(this, "vss_physics_step_one_thread"), phys(this, "vss_physics_step_one_thread_capped"),
                            r"vss_physics_(thread_)?kernel"),
        }
        turns = {name: [device_us(fn, TIMED_LAUNCHES, match)[0]
                        for fn in (base, group, thread, capped, capped, thread, group, base)]
                 for name, (base, group, thread, capped, match) in kernels.items()}
        mean_us = {n: {"baseline_thread": (t[0] + t[7]) / 2, "group": (t[1] + t[6]) / 2, "thread": (t[2] + t[5]) / 2,
                       "capped": (t[3] + t[4]) / 2} for n, t in turns.items()}
        routed = {n: (vp if n == "vss_physics" else vf).routed_entry(env, batch) for n in kernels}
        design = {n: "group" if "one_thread" not in e else "capped" if e.endswith("_capped") else "thread"
                  for n, e in routed.items()}
        phase("vss_5v5_baseline_turns", card=card, B=batch, bit_equal=True, comparisons=n_cmp,
              baselinethread_group_thread_capped_capped_thread_group_baselinethread_us=turns, mean_us=mean_us,
              routed_entry=routed, faster={n: min(("group", "thread", "capped"), key=m.get) for n, m in mean_us.items()},
              routed_vs_baseline={n: m[design[n]] / m["baseline_thread"] for n, m in mean_us.items()})


def tensor_leaves(tree):
    """Leaves of a tensor or of (nested) NamedTuples of tensors."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tensor_leaves(sub)]
    return [tree]


def fork(carry):
    """A copy of a rollout carry: its state, key and policy stream advance
    apart from the original's."""
    gen = torch.Generator(device=carry.ep_return.device)
    gen.set_state(carry.pol_gen.get_state())
    state = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, carry.state)
    return carry._replace(state=state, key=carry.key.clone(), pol_gen=gen)


def rel_err(got, want: float) -> float:
    return abs(float(got) - want) / max(abs(want), 1e-30)


def epilogue_vs_plain(benv, carry) -> dict:
    """The rollout epilogue (``make_rollout_fn`` on the card) against the
    plain torch bookkeeping (``make_step_fn`` with ``rollout_metrics``) on
    the card, both from a fork of ``carry`` for ``EPILOGUE_STEPS`` steps:
    the carries bit for bit; the episode count and length sum exactly as,
    and the reward and return sums within rel 1e-6 of, a float64 sum of the
    plain run's per-step reward and pre-reset accumulators on the host; one
    epilogue a step and one finish.  Returns the largest difference of the
    accumulators and the sums' relative errors."""
    from rsoccer_tpu_torch.batch import rollout as R

    before = tracing.snapshot()
    c_e, m_e = R.make_rollout_fn(benv, EPILOGUE_STEPS)(fork(carry))
    launched = tracing.entry_launches(rollout_epilogue.WRAPPER, since=before)
    if launched != {"rollout_epilogue": EPILOGUE_STEPS, "rollout_epilogue_finish": 1}:
        raise AssertionError(f"epilogue vs plain: launches {launched}, want {EPILOGUE_STEPS} and 1 finish")
    seen = []

    def metrics(reward, done, ep_ret, ep_len, info):
        seen.append([t.double().cpu() for t in (reward, done, ep_ret, ep_len)])
        return R.rollout_metrics(reward, done, ep_ret, ep_len, info)

    one_step = R.make_step_fn(benv, R.uniform_policy(benv.action_size), metrics)
    c_p = fork(carry)
    for _ in range(EPILOGUE_STEPS):
        c_p, _ = one_step(c_p)
    got = [*tensor_leaves(c_e.state), c_e.obs, c_e.key, c_e.ep_return, c_e.ep_length]
    want = [*tensor_leaves(c_p.state), c_p.obs, c_p.key, c_p.ep_return, c_p.ep_length]
    if not all(torch.equal(a, b) for a, b in zip(got[:-2], want[:-2])) or not bit_equal(got[-2:], want[-2:]):
        raise AssertionError("epilogue vs plain: the carries differ")
    tot_r = ret_sum = len_sum = 0.0
    eps = 0
    for r, d, er, el in seen:
        tot_r += float(r.sum())
        eps += int(d.sum())
        ret_sum += float((er * d).sum())
        len_sum += float((el * d).sum())
    if m_e.episodes.dtype != torch.int64 or int(m_e.episodes) != eps:
        raise AssertionError(f"epilogue vs plain: {int(m_e.episodes)} episodes, want {eps}")
    if float(m_e.episode_length_sum) != float(torch.tensor(len_sum, dtype=torch.float64).float()):
        raise AssertionError(f"epilogue vs plain: length sum {float(m_e.episode_length_sum)}, want {len_sum}")
    errs = {"reward_rel_err": rel_err(m_e.total_reward, tot_r),
            "return_rel_err": rel_err(m_e.episode_return_sum, ret_sum)}
    if max(errs.values()) > 1e-6:
        raise AssertionError(f"epilogue vs plain: reward sums off a float64 recount by {errs}")
    diff = max(max_err(a, b) for a, b in zip(got[-2:], want[-2:]))
    return {"steps": EPILOGUE_STEPS, "episodes": eps, "max_abs_err": diff, **errs}


def epilogue_record(card, launches: int, err: float) -> dict:
    """The rollout epilogue alone, one step at ``EPILOGUE_TIMED_B`` envs on
    drawn operands, against the plain loop's torch bookkeeping of a step
    (``make_step_fn``'s accumulators and ``rollout_metrics``' sums with their
    add to the running sums); the bound is its ~22 bytes an env over the
    HBM rate.  The calls take ``EPILOGUE_SETS`` operand sets in turn, more
    bytes than the card's 50 MB L2 holds, so each reads device memory.
    Returns its record for the final JSON line."""
    from rsoccer_tpu_torch.batch import rollout as R

    b = EPILOGUE_TIMED_B
    g = torch.Generator(device="cuda").manual_seed(5)

    def operands():
        return (torch.randn(b, generator=g, device="cuda"),
                torch.rand(b, generator=g, device="cuda") < 0.01,
                torch.rand(b, generator=g, device="cuda") < 0.001,
                torch.randn(b, generator=g, device="cuda"),
                torch.randint(0, 1200, (b,), generator=g, device="cuda").float())

    sets = [operands() for _ in range(EPILOGUE_SETS)]
    turn = itertools.cycle(sets)
    acc = rollout_epilogue.scratch("cuda")
    outs = rollout_epilogue.epilogue(*sets[0], acc, first=True)
    reward, term, trunc, ep_ret, ep_len = sets[0]
    total = R.rollout_metrics(reward, term | trunc, ep_ret, ep_len, None)

    def kernel():
        rollout_epilogue.epilogue(*next(turn), acc, first=False)

    def plain(ins=None):
        reward, term, trunc, ep_ret, ep_len = ins or next(turn)
        done = term | trunc
        er, el = ep_ret + reward, ep_len + 1.0
        tree_map(torch.add, total, R.rollout_metrics(reward, done, er, el, None))
        return torch.where(done, 0.0, er), torch.where(done, 0.0, el)

    if not bit_equal(outs, plain(sets[0])):
        raise AssertionError("epilogue alone: accumulators differ from the plain bookkeeping")
    kern_us, _ = device_us(kernel, TIMED_LAUNCHES, r"rollout_epilogue_kernel")
    plain_us, plain_top = device_us(plain, TIMED_LAUNCHES)
    bound, by, bytes_ms, _ = bound_ms(sets[0], outs, 8, 0, 0)
    phase("rollout_epilogue_time", card=card, B=b, device_us=kern_us, plain_device_us=plain_us,
          bound_us=bound * 1e3, bound_by=by, roofline_share=bytes_ms * 1e3 / kern_us,
          plain_top_kernels_us=plain_top)
    return {
        "name": "rollout_epilogue_kernel (one step, 1048576 envs)",
        "route": "cuda",
        "source": "rsoccer_tpu_torch/csrc/rollout_epilogue.cu",
        "replaces": None,  # no TPU kernel: XLA fuses this bookkeeping into rsoccer_tpu/batch/rollout.py's scan
        "launches": launches,
        "ms": kern_us / 1e3,
        "plain_ms": plain_us / 1e3,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call updates the accumulators and sums
        "max_abs_err": err,
    }


def main_path(task, tasks, card):
    """Drive the task's main path with every launch count zeroed just
    before and read just after; time it, its kernel and its plain version;
    hold its rollout epilogue to the plain bookkeeping.  Returns the
    kernel's record for the final JSON line (without max_abs_err) and the
    epilogue's launches and largest error."""
    from rsoccer_tpu_torch.batch import rollout as R

    env = make_env(task)
    benv = task.make_benv(env)
    carry = R.init_carry(benv, seed=0)
    rollout = R.make_rollout_fn(benv, ROLLOUT_STEPS)
    timed, profile_steps = task.timed_rollouts, task.profile_steps
    for _ in range(task.warm_rollouts):
        carry, _ = rollout(carry)
    torch.cuda.synchronize()
    wrappers = list({id(t.wrapper): t.wrapper for t in tasks}.values())
    tracing.clear_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    episodes = 0
    t_host = time.perf_counter()
    start.record()
    for _ in range(timed):
        carry, ms = rollout(carry)
        episodes += ms.episodes  # device tensor; read after the window
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t_host
    launches = {w.__name__: tracing.launches(w) for w in wrappers}
    roll_ms = start.elapsed_time(end)
    n_steps = timed * ROLLOUT_STEPS
    want = {w.__name__: (n_steps if w is task.wrapper else 0) for w in wrappers}
    if launches != want:
        raise AssertionError(f"{task.name} main path: launches {launches}, want {want}")
    by_entry = tracing.entry_launches(task.wrapper)  # the C entry the route names must take every launch
    entry = routed_entry(task, B)
    if by_entry != {entry: n_steps}:
        raise AssertionError(f"{task.name} main path: launches by C entry {by_entry}, "
                             f"want {entry} x {n_steps}")
    epilogue = tracing.entry_launches(rollout_epilogue.WRAPPER)  # one a step, one finish a call
    if epilogue != {"rollout_epilogue": n_steps, "rollout_epilogue_finish": timed}:
        raise AssertionError(f"{task.name} main path: epilogue launches {epilogue}, "
                             f"want {n_steps} steps and {timed} finishes")
    obs = carry.obs
    if tuple(obs.shape) != (env.obs_size, B) or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"{task.name}: main-path obs not finite or of the wrong shape")
    if bool((obs.abs() > torch.tensor(1.2, dtype=torch.float32)).any()):
        raise AssertionError(f"{task.name}: main-path obs outside +-1.2 (f32)")
    if not all(bool(torch.isfinite(t).all()) for t in tensor_leaves(carry.state)
               if t.is_floating_point()):
        raise AssertionError(f"{task.name}: main-path state not finite")
    episodes = int(episodes)
    if episodes <= 0:
        raise AssertionError(f"{task.name}: no episode ended in the main-path run")
    env_steps_per_s = n_steps * B / (roll_ms / 1e3)

    # kernel alone vs its plain version, same shapes, same stream: the
    # time per call seen from the host (CUDA events over back-to-back
    # calls) and the device time per call (profiler)
    calls = task.calls(task, env, carry)
    call_us = {"kernel_rng" if "kernel_input" in calls else "kernel":
               time_cuda(calls["kernel"], TIMED_LAUNCHES) * 1e3}
    dev_us = {}
    if "kernel_input" in calls:
        call_us["kernel_input"] = time_cuda(calls["kernel_input"], TIMED_LAUNCHES) * 1e3
    call_us["plain"] = time_cuda(calls["plain"], 20) * 1e3
    call_us["kernel_again"] = time_cuda(calls["kernel"], TIMED_LAUNCHES) * 1e3
    kern_dev_us, _ = device_us(calls["kernel"], TIMED_LAUNCHES, task.kernel_match)
    dev_us["kernel_rng" if "kernel_input" in calls else "kernel"] = kern_dev_us
    if "kernel_input" in calls:
        dev_us["kernel_input"], _ = device_us(calls["kernel_input"], TIMED_LAUNCHES, task.kernel_match)
    plain_dev_us, plain_top = device_us(calls["plain"], 10)
    dev_us["plain"] = plain_dev_us
    roll_dev_us, roll_top = device_us(lambda: R.make_rollout_fn(benv, profile_steps)(carry), 1,
                                      table=f"profile_rollout_{task.name}.txt")
    loop = _trace.rollout_loop(lambda: R.make_rollout_fn(benv, profile_steps)(carry), LOOP_PROBE_CALLS)
    epi = epilogue_vs_plain(benv, carry)
    rollout_us_per_step = roll_ms * 1e3 / n_steps
    outs = calls["kernel"]()
    bound, bound_by, bytes_ms, ops_ms = bound_ms(calls["ins"], outs, task.ops_env, task.ops_reset, calls["n_done"](outs))
    extra = {}
    if "ins_input" in calls:
        b_in = bound_ms(calls["ins_input"], outs, task.ops_env, task.ops_reset, calls["n_done"](outs))
        extra = {"bound_input_rows_us": b_in[0] * 1e3, "bound_input_rows_by": b_in[1]}
    phase(f"main_path_{task.name}", card=card, env=task.env_id, env_kwargs=task.env_kwargs, B=B,
          steps=n_steps, launches=launches[task.wrapper.__name__], entry=routed_entry(task, B),
          episodes=episodes, rollout_ms=roll_ms, host_s=host_s,
          env_steps_per_s=env_steps_per_s, rollout_us_per_step=rollout_us_per_step)
    phase(f"kernel_vs_plain_time_{task.name}", card=card, B=B, call_us=call_us,
          device_us=dev_us, bound_us=bound * 1e3, bound_by=bound_by, bound_bytes_us=bytes_ms * 1e3,
          bound_ops_us=ops_ms * 1e3, **extra, plain_top_kernels_us=plain_top)
    phase(f"rollout_device_{task.name}", card=card, steps=profile_steps,
          device_us_per_step=roll_dev_us / profile_steps,
          device_busy_share=roll_dev_us / profile_steps / rollout_us_per_step,
          top_kernels_us_per_rollout=roll_top, epilogue_launches=epilogue,
          loop_device_us_per_step=loop["loop_device_us"], launches_per_step=loop["launches"], loop=loop)
    phase(f"epilogue_vs_plain_{task.name}", card=card, B=B, **epi)
    return {
        "name": task.kernel,
        "route": "cuda",
        "source": task.source,
        "replaces": task.replaces,
        "launches": launches[task.wrapper.__name__],
        "ms": kern_dev_us / 1e3,
        "plain_ms": plain_dev_us / 1e3,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes an env step or its physics
    }, {"launches": sum(epilogue.values()), "max_abs_err": epi["max_abs_err"]}


# ---- PPO on the card: the learner of the main path
PPO_UPDATES = 10
PPO_CONFIG = dict(hidden=(256, 256), rollout_steps=128, num_epochs=4, num_minibatches=8,
                  minibatch_mode="shuffle")
ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")
# artifacts/README.md: vss_ppo on the absolute VSS anchor (1024 envs x 4800
# steps, deterministic policy), and the SSL PPO checkpoints' deterministic
# eval (env id, success rate, episodes, floor where the band is empty)
VSS_ANCHOR_REF = {"episodes": 9142, "blue_goal_rate": 0.729, "yellow_goal_rate": 0.068,
                  "mean_goal_diff": 0.66}
SSL_PPO_REFS = {
    "cp_ppo2": ("SSLContestedPossession-v0", 0.989, 2285, None),
    "sd_ppo3": ("SSLStaticDefenders-v0", 0.871, 22188, None),
    "drb_ppo": ("SSLDribbling-v0", 1.000, 5632, 0.990),
}


# The reference Dribbling task draws no noise: every episode of a
# deterministic policy runs the same course, so a success rate of 100% can
# not move, but the course's length can.  The JAX package's course lengths
# on its XLA path (tests/test_torch_reference_scores.py, run as a script):
DR_COURSE_JAX = {"drb_ppo": 217.0, "drb_sac": 249.0, "dr_expert": 510.0}
# A closed loop carries a rounding difference forward (the port's CPU
# path and the JAX package's split by 1e-7 at the first step and by 1e-4
# after 50; the port's CPU course of drb_sac is 246 steps): the length
# gate allows 5% of the course, where a wrong step or automaton moves more.
DR_COURSE_TOL = 0.05


def dr_course_gate(name: str, mean_length: float) -> dict:
    """The course-length gate of a Dribbling run: its fields for the
    phase line, ``course_inside`` among them."""
    ref = DR_COURSE_JAX[name]
    band = [ref * (1 - DR_COURSE_TOL), ref * (1 + DR_COURSE_TOL)]
    return {"course_steps": mean_length, "course_steps_jax_cpu": ref, "course_band": band,
            "course_inside": band[0] <= mean_length <= band[1]}


def two_sample_band(ref: float, var: float, n_ref: int, n: int) -> list:
    """ref +- 3 sigma of the difference of two independent sample means of
    a quantity of per-episode variance ``var``, over n_ref and n episodes."""
    half = 3.0 * math.sqrt(var * (1.0 / n_ref + 1.0 / max(n, 1)))
    return [ref - half, ref + half]


def goal_bands(ref, n: int) -> dict:
    """Two-sample 3-sigma bands of the blue goal rate and the goal diff
    around ``ref`` = (blue rate, episodes, yellow rate, goal diff), for a
    run of ``n`` episodes (a per-episode goal diff of +1, -1 or 0)."""
    p_b, n_ref, p_y, diff = ref
    return {"blue_goal_rate": two_sample_band(p_b, p_b * (1 - p_b), n_ref, n),
            "mean_goal_diff": two_sample_band(diff, p_b + p_y - (p_b - p_y) ** 2, n_ref, n)}


def check_launches(tag, wrappers, wrapper, entry, n, final=None):
    """After a run that began with ``tracing.clear_launches()``: ``wrapper``
    launched ``n`` times, all through the C entry ``entry`` (and ``final``
    of them its ``emit_final`` variant, where given), every other wrapper
    never.  Returns the launch counts."""
    launches = {w.__name__: tracing.launches(w) for w in wrappers}
    want = {w.__name__: (n if w is wrapper else 0) for w in wrappers}
    by_entry = tracing.entry_launches(wrapper)
    finals = tracing.launches(wrapper, final=True)
    if launches != want or by_entry != {entry: n} or (final is not None and finals != final):
        raise AssertionError(f"{tag}: launches {launches} by entry {by_entry}, emit_final {finals}; "
                             f"want {want}, all through {entry}, emit_final {final}")
    return launches


def vss_entry(benv):
    """The C entry of K1 that a fused VSS ``benv`` launches."""
    from rsoccer_tpu_torch.ops import vss_full as vf

    return vf.routed_entry(benv.env, benv.n_envs)


def ppo_train(card, wrappers):
    """The PPO main path: VSS-v0 at B envs on the fused kernel-RNG path (K1's
    group kernel, ``emit_final``), towers (256, 256) in bf16, PPO_UPDATES
    updates from a fresh init through ``PPOTrainer.train_step``, every launch
    count zeroed just before and read just after.  Fails on a non-finite
    loss, on params that do not move, or on launches other than K1's
    emit_final variant once per env step.  Returns (trainer, state, the
    phase's numbers)."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer
    from rsoccer_tpu_torch.ops import vss_full as vf

    benv = rt.make_vec("VSS-v0", B, device="cuda", fused=True, fused_rng="kernel")
    cfg = PPOConfig(**PPO_CONFIG)
    trainer = PPOTrainer(benv, cfg)
    state = trainer.init(0)
    p0 = [p.detach().clone() for p in state.net.parameters()]
    torch.cuda.synchronize()
    tracing.clear_launches()
    rows = []
    t_prev = time.perf_counter()
    for i in range(PPO_UPDATES):
        state, m = trainer.train_step(state)
        row = {"update": i, **{k: float(m[k]) for k in ("mean_reward", "loss", "entropy", "value_loss")},
               **trainer.phase_ms()}
        now = time.perf_counter()
        row["wall_ms"] = (now - t_prev) * 1e3
        t_prev = now
        if not all(math.isfinite(row[k]) for k in ("loss", "entropy", "value_loss")):
            raise AssertionError(f"ppo_train: non-finite loss at update {i}: {row}")
        rows.append(row)
        phase("ppo_update", **row)
    n_steps = PPO_UPDATES * cfg.rollout_steps
    entry = vss_entry(benv)
    launches = check_launches("ppo_train", wrappers, vf.vss_full_step, entry, n_steps, final=n_steps)
    moved = [not torch.equal(a, b) for a, b in zip(p0, state.net.parameters())]
    if not all(moved):
        raise AssertionError(f"ppo_train: parameters that did not move: {moved}")
    steady = rows[1:]  # the first update carries one-time set-up (cuBLAS, allocator)
    mean = {k: sum(r[k] for r in steady) / len(steady) for k in ("collect_ms", "update_ms", "wall_ms")}
    out = {
        "B": B, "config": {**PPO_CONFIG, "hidden": list(cfg.hidden)}, "updates": PPO_UPDATES,
        "launches": launches["vss_full_step"], "entry": entry,
        "final_launches": tracing.launches(vf.vss_full_step, final=True),
        "env_steps_per_s": cfg.rollout_steps * B / (mean["wall_ms"] / 1e3),
        "collect_ms_per_update": mean["collect_ms"], "update_ms_per_update": mean["update_ms"],
        "collect_ms_per_step": mean["collect_ms"] / cfg.rollout_steps,
        "wall_ms_per_update": mean["wall_ms"], "first_update_wall_ms": rows[0]["wall_ms"],
        "reward_per_step": [r["mean_reward"] for r in rows],
    }
    phase("ppo_train", card=card, **out)
    return trainer, state, out


def ppo_resume(trainer, state):
    """Save the whole training state, restore it, hold the params bit for
    bit, then one more update from each: equal params, env state and key.
    Returns the restored state after its update."""
    from rsoccer_tpu_torch.utils import checkpoint

    path = os.path.join(OUT_DIR, "ppo_resume.ckpt")
    checkpoint.save(path, trainer.state_tree(state))
    back = trainer.state_from_tree(checkpoint.restore(path, like=trainer.state_tree(state)))
    restored = bit_equal(list(state.net.parameters()), list(back.net.parameters()))
    s1, m1 = trainer.train_step(state)
    s2, m2 = trainer.train_step(back)
    torch.cuda.synchronize()
    same = {
        "params": bit_equal(list(s1.net.parameters()), list(s2.net.parameters())),
        "env_state": torch.equal(s1.env_state, s2.env_state),
        "env_key": torch.equal(s1.env_key, s2.env_key),
        "loss": bool(torch.equal(m1["loss"], m2["loss"])),
    }
    phase("ppo_resume", file=path + ".npz", bytes=os.path.getsize(path + ".npz"),
          restored_bit_equal=restored, after_one_update_equal=same, update_step=s2.update_step)
    if not (restored and all(same.values())):
        raise AssertionError(f"ppo_resume: restored {restored}, after one more update {same}")
    return trainer, s2


def ppo_profile(card, trainer, state, k1, train_out):
    """One train step under the profiler: K1's device time per launch on
    the PPO path and its share of the collect step, and the step's top
    kernels; then K1's emit_final variant alone against its plain version
    on the path's last state.  Returns the kernel's record for the final
    JSON line (without max_abs_err) and the variant's largest error against
    its plain version on that state."""
    from rsoccer_tpu_torch.models.ppo import make_policy
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops.philox import make_key

    box = [state]

    def one_update():
        box[0], _ = trainer.train_step(box[0])

    k1_us, step_us, top = device_us_split(one_update, 1, k1.kernel_match, table="profile_ppo_train_step.txt")
    env, st = trainer.benv.env, box[0].env_state
    act = make_policy(box[0].net, box[0].obs_norm, deterministic=False)(
        torch.Generator(device="cuda").manual_seed(7), box[0].obs)
    key = make_key(3, device="cuda")
    outs = vf.vss_full_step(env, st, act, key=key.clone(), emit_final=True)
    err, _ = compare_step(env.n_robots, outs, vf.vss_full_step_plain(
        env, st, act, *vf.draw_step_rows(env, key.clone(), B), True), "ppo_profile emit_final")

    def kernel():
        return vf.vss_full_step(env, st, act, key=key, emit_final=True)

    def plain():
        return vf.vss_full_step_plain(env, st, act, *vf.draw_step_rows(env, key, B), True)

    kern_dev_us, _ = device_us(kernel, TIMED_LAUNCHES, k1.kernel_match)
    plain_dev_us, _ = device_us(plain, 10)
    n_done = int(((outs[2][1] > 0.5) | (outs[2][2] > 0.5)).sum())
    bound, by, _, _ = bound_ms((st, act, key), outs, k1.ops_env, k1.ops_reset, n_done)
    share = k1_us * PPO_CONFIG["rollout_steps"] / (train_out["collect_ms_per_update"] * 1e3)
    phase("ppo_profile", card=card, k1_emit_final_device_us_per_launch_in_train_step=k1_us,
          train_step_device_ms=step_us / 1e3, k1_share_of_collect=share,
          k1_emit_final_alone_device_us=kern_dev_us, plain_emit_final_device_us=plain_dev_us,
          bound_us=bound * 1e3, bound_by=by, max_abs_err_vs_plain=err,
          top_kernels_us_per_train_step=top)
    return {
        "name": "vss_full_kernel (emit_final, PPO collect)",
        "route": "cuda",
        "source": k1.source,
        "replaces": k1.replaces,
        "launches": train_out["final_launches"],
        "ms": kern_dev_us / 1e3,
        "plain_ms": plain_dev_us / 1e3,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes an env step
    }, err


def ppo_checkpoint(card, wrappers):
    """artifacts/vss_ppo.ckpt.npz through convert (no jax) on the absolute
    VSS anchor (tools/vss_anchor_eval) on the fused kernel-RNG path: blue
    goal rate and goal diff inside the two-sample 3-sigma band around the
    reference's, with every step one launch of K1 without ``emit_final``
    and no other kernel launched."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch import convert
    from rsoccer_tpu_torch.models.ppo import make_policy
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.tools.vss_anchor_eval import anchor_eval

    net, obs_norm = convert.load_ppo_checkpoint(os.path.join(ARTIFACTS, "vss_ppo.ckpt.npz"), device="cuda")
    benv = rt.make_vec("VSS-v0", 1024, device="cuda", fused=True, fused_rng="kernel")
    tracing.clear_launches()
    t0 = time.perf_counter()
    out = anchor_eval(benv, make_policy(net, obs_norm, deterministic=True), 4800, seed=123)
    secs = time.perf_counter() - t0
    launches = check_launches("ppo_checkpoint", wrappers, vf.vss_full_step, vss_entry(benv), 4800, final=0)
    ref = VSS_ANCHOR_REF
    bands = goal_bands((ref["blue_goal_rate"], ref["episodes"], ref["yellow_goal_rate"], ref["mean_goal_diff"]),
                       out["episodes"])
    inside = {k: lo <= out[k] <= hi for k, (lo, hi) in bands.items()}
    phase("ppo_checkpoint", card=card, checkpoint="artifacts/vss_ppo.ckpt.npz", envs=1024, steps=4800,
          **out, reference=ref, band_3sigma=bands, inside=inside, launches=launches, entry=vss_entry(benv),
          seconds=secs)
    if not all(inside.values()):
        raise AssertionError(f"ppo_checkpoint: vss_ppo outside the band: {out} against {bands}")


def ppo_ssl_checkpoints(card, wrappers, ssl_tasks):
    """The shipped SSL PPO checkpoints through eval.evaluate_policy (default
    envs and steps, deterministic policy) on the fused kernel-RNG path (K4,
    K5, K6): each success rate inside the two-sample 3-sigma band around
    artifacts/README.md's, or above its floor where the band is empty, with
    every step one launch of the env's kernel and no other kernel launched."""
    from rsoccer_tpu_torch import convert
    from rsoccer_tpu_torch.eval import evaluate_policy
    from rsoccer_tpu_torch.models.ppo import make_policy
    from rsoccer_tpu_torch.ops import ssl_full as sf

    task_of = {t.env_id: t for t in ssl_tasks}
    misses = {}
    for name, (env_id, p_ref, n_ref, floor) in SSL_PPO_REFS.items():
        net, obs_norm = convert.load_ppo_checkpoint(os.path.join(ARTIFACTS, f"{name}.ckpt.npz"), device="cuda")
        tracing.clear_launches()
        t0 = time.perf_counter()
        out = evaluate_policy(env_id, make_policy(net, obs_norm, deterministic=True), device="cuda",
                              fused=True)
        secs = time.perf_counter() - t0
        task = task_of[env_id]
        entry = sf.routed_entry(task.entry, out["n_envs"])
        check_launches(f"ppo_ssl_checkpoint {name}", wrappers, task.wrapper, entry, out["n_steps"])
        lo, hi = two_sample_band(p_ref, p_ref * (1 - p_ref), n_ref, out["episodes"])
        if floor is not None:
            lo = min(lo, floor)
        inside = lo <= out["success_rate"] <= hi
        course = dr_course_gate(name, out["mean_episode_length"]) if name in DR_COURSE_JAX else {}
        launches = {task.wrapper.__name__: tracing.entry_launches(task.wrapper)}
        phase("ppo_ssl_checkpoint", card=card, checkpoint=f"artifacts/{name}.ckpt.npz", **out,
              reference={"success_rate": p_ref, "episodes": n_ref}, band_3sigma=[lo, hi], floor=floor,
              inside=inside, **course, launches=launches, seconds=secs)
        if not inside or not course.get("course_inside", True):
            misses[name] = (out["success_rate"], [lo, hi], course)
    if misses:
        raise AssertionError(f"ppo_ssl_checkpoints: outside the band: {misses}")


# ---- SAC on the card: the learner of the StaticDefenders path
SAC_ENVS = 512
SAC_ITERS = 1000  # halved from 2000 to keep the whole script near half its time limit
SAC_STEADY_FROM = 100  # the first iterations carry one-time set-up (cuBLAS, allocator)
SAC_SAMPLE_EVERY = 100  # phase_ms (a sync) at every 100th iteration only
# artifacts/README.md "SD best": 512 envs, reward scale 10, n-step 8, gamma
# 0.995, target entropy 0.5 x A, f32 towers (256, 256), batch 512, 2 grad
# steps per iteration, a ring of 1 << 18, warmup 50
SAC_CONFIG = dict(buffer_size=1 << 18, batch_size=512, grad_steps_per_iter=2, n_step=8, gamma=0.995,
                  reward_scale=10.0, target_entropy_scale=0.5, warmup_steps=50, hidden=(256, 256))
# artifacts/README.md: the shipped SAC actors' deterministic eval (env id,
# success rate, episodes), scored here at 1024 envs for the steps given
SAC_REFS = {
    "sac_sd_best2": ("SSLStaticDefenders-v0", 0.938, 14633, 2000),
    "sac_cp_nstep": ("SSLContestedPossession-v0", 0.977, 22306, 2400),
}
SAC_EVAL_ENVS = 1024


def sac_train(card, wrappers):
    """The SAC main path: SSLStaticDefenders-v0 at SAC_ENVS envs on the fused
    kernel-RNG path (K4's group kernel, ``emit_final``), the SD recipe
    (SAC_CONFIG), SAC_ITERS iterations from a fresh init through
    ``SACTrainer.train_step``, every launch count zeroed just before and
    read just after.  Fails on a non-finite loss, on actor or critic params
    that did not move, or on launches other than K4's emit_final variant
    once per iteration through ``ssl_sd_full_step``.  Returns (trainer,
    state, the phase's numbers)."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.models.sac import SACConfig, SACTrainer, iteration_generator
    from rsoccer_tpu_torch.ops import ssl_full as sf

    benv = rt.make_vec("SSLStaticDefenders-v0", SAC_ENVS, device="cuda", fused=True, fused_rng="kernel")
    entry = sf.routed_entry("ssl_sd_full_step", SAC_ENVS)
    if entry != "ssl_sd_full_step" or sf.route("ssl_sd_full_step", SAC_ENVS) != "group":
        raise AssertionError(f"sac_train: {SAC_ENVS} envs route to {entry}, not the group kernel")
    trainer = SACTrainer(benv, SACConfig(**SAC_CONFIG))
    state = trainer.init(0)
    p0 = [p.detach().clone() for m in (state.actor, state.qs) for p in m.parameters()]
    torch.cuda.synchronize()
    tracing.clear_launches()
    samples = []
    t0 = time.perf_counter()
    for i in range(SAC_ITERS):
        state, m = trainer.train_step(state, iteration_generator(0, i))
        if i == 0:
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        if i == SAC_STEADY_FROM - 1:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        if (i + 1) % SAC_SAMPLE_EVERY == 0:
            row = {"iter": i, **{k: float(v) for k, v in m.items()}, **trainer.phase_ms()}
            if not all(math.isfinite(row[k]) for k in ("q_loss", "actor_loss", "alpha", "mean_reward")):
                raise AssertionError(f"sac_train: non-finite metrics at iteration {i}: {row}")
            samples.append(row)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t_steady
    launches = check_launches("sac_train", wrappers, sf.sd_full_step, entry, SAC_ITERS, final=SAC_ITERS)
    moved = [not torch.equal(a, b) for a, b in zip(p0, (p for m in (state.actor, state.qs) for p in m.parameters()))]
    if not all(moved):
        raise AssertionError(f"sac_train: actor or critic parameters that did not move: {moved}")
    steady = [r for r in samples if r["iter"] >= SAC_STEADY_FROM]
    iters_per_s = (SAC_ITERS - SAC_STEADY_FROM) / steady_s
    out = {
        "B": SAC_ENVS, "config": {**SAC_CONFIG, "hidden": list(SAC_CONFIG["hidden"])}, "iters": SAC_ITERS,
        "launches": launches["sd_full_step"], "entry": entry, "final_launches": tracing.launches(sf.sd_full_step, final=True),
        "iters_per_s": iters_per_s, "env_steps_per_s": iters_per_s * SAC_ENVS,
        "wall_ms_per_iter": 1e3 / iters_per_s,
        "collect_ms_per_iter": sum(r["collect_ms"] for r in steady) / len(steady),
        "update_ms_per_iter": sum(r["update_ms"] for r in steady) / len(steady),
        "first_iter_wall_ms": first_ms,
        "samples": [{k: r[k] for k in ("iter", "mean_reward", "q_loss", "actor_loss", "alpha")} for r in samples],
    }
    phase("sac_train", card=card, **out)
    return trainer, state, out


def sac_resume(trainer, state):
    """Save the whole SAC state (replay ring included), restore it, hold
    it bit for bit, then one more iteration from each with the same draws:
    params, ring, env state, key, log_alpha, Adam and metrics equal bit for
    bit.  The file (~60 MB, mostly the ring) is deleted after the check.
    Returns the restored state after its iteration."""
    from rsoccer_tpu_torch.models.sac import iteration_generator
    from rsoccer_tpu_torch.utils import checkpoint

    def flat(s):
        return [torch.as_tensor(x) for x in checkpoint.flatten(trainer.state_tree(s))]

    path = os.path.join(OUT_DIR, "sac_resume.ckpt")
    checkpoint.save(path, trainer.state_tree(state))
    n_bytes = os.path.getsize(path + ".npz")
    back = trainer.state_from_tree(checkpoint.restore(path, like=trainer.state_tree(state)))
    os.remove(path + ".npz")
    restored = all(torch.equal(a, b.to(a.device)) for a, b in zip(flat(state), flat(back)))
    s1, m1 = trainer.train_step(state, iteration_generator(0, SAC_ITERS))
    s2, m2 = trainer.train_step(back, iteration_generator(0, SAC_ITERS))
    torch.cuda.synchronize()
    t1, t2 = trainer.state_tree(s1), trainer.state_tree(s2)

    def same(k):
        return all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                   for a, b in zip(checkpoint.flatten(t1[k]), checkpoint.flatten(t2[k])))

    eq = {k: same(k) for k in ("actor", "qs", "qs_target", "log_alpha", "adam", "buffer", "env_state",
                               "env_key", "obs", "total_steps", "iteration")}
    eq["metrics"] = all(torch.equal(m1[k], m2[k]) for k in m1)
    phase("sac_resume", bytes=n_bytes, restored_bit_equal=restored, after_one_iteration_equal=eq,
          iteration=s2.iteration, ring_filled=s2.buffer.filled)
    if not (restored and all(eq.values())):
        raise AssertionError(f"sac_resume: restored {restored}, after one more iteration {eq}")
    return trainer, s2


def sac_profile(card, trainer, state, k4, train_out):
    """Train iterations under the profiler: K4's emit_final device time
    per launch on the SAC path, its share of the collect, the device time
    per iteration and the busy share, and the top kernels
    (chiprun_out/profile_sac_train_step.txt); then the variant alone at
    SAC_ENVS envs against its plain version on the path's last state.
    Returns the kernel's record for the final JSON line (without
    max_abs_err) and the variant's largest error against its plain
    version on that state."""
    from rsoccer_tpu_torch.models.sac import iteration_generator, make_policy
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops.philox import make_key

    box = [state]
    n_iter = 20

    def one_iter():
        box[0], _ = trainer.train_step(box[0], iteration_generator(0, box[0].iteration))

    k4_us, iter_us, top = device_us_split(one_iter, n_iter, k4.kernel_match, table="profile_sac_train_step.txt")
    env, st = trainer.benv.env, box[0].env_state
    act = make_policy(box[0].actor, deterministic=False)(torch.Generator(device="cuda").manual_seed(7),
                                                         box[0].obs)
    key = make_key(3, device="cuda")
    outs = sf.sd_full_step(env, st, act, key=key.clone(), emit_final=True)
    err, _ = compare_step(env.n_robots, outs, sf.sd_full_step_plain(
        env, st, act, *sf.sd_draw_step_rows(env, key.clone(), SAC_ENVS), True), "sac_profile emit_final")

    def kernel():
        return sf.sd_full_step(env, st, act, key=key, emit_final=True)

    def plain():
        return sf.sd_full_step_plain(env, st, act, *sf.sd_draw_step_rows(env, key, SAC_ENVS), True)

    kern_dev_us, _ = device_us(kernel, TIMED_LAUNCHES, k4.kernel_match)
    plain_dev_us, _ = device_us(plain, 10)
    n_done = int(((outs[2][1] > 0.5) | (outs[2][2] > 0.5)).sum())
    bound, by, bytes_ms, ops_ms = bound_ms((st, act, key), outs, k4.ops_env, k4.ops_reset, n_done)
    phase("sac_profile", card=card, B=SAC_ENVS, k4_emit_final_device_us_per_launch_in_train_step=k4_us,
          k4_share_of_collect=k4_us / (train_out["collect_ms_per_iter"] * 1e3),
          train_iter_device_ms=iter_us / 1e3,
          device_busy_share=iter_us / 1e3 / train_out["wall_ms_per_iter"],
          k4_emit_final_alone_device_us=kern_dev_us, plain_emit_final_device_us=plain_dev_us,
          bound_us=bound * 1e3, bound_by=by, bound_bytes_us=bytes_ms * 1e3, bound_ops_us=ops_ms * 1e3,
          max_abs_err_vs_plain=err, top_kernels_us_per_train_iter=top)
    return {
        "name": "sd_full_kernel (emit_final, SAC collect, 512 envs)",
        "route": "cuda",
        "source": k4.source,
        "replaces": k4.replaces,
        "launches": train_out["final_launches"],
        "ms": kern_dev_us / 1e3,
        "plain_ms": plain_dev_us / 1e3,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes an env step
    }, err


def sac_checkpoint(card, wrappers, ssl_tasks):
    """The shipped SAC actors through convert.load_sac_checkpoint (no jax)
    and eval.evaluate_policy (deterministic policy, default env) at
    SAC_EVAL_ENVS envs on the fused kernel-RNG path: each success rate
    inside the two-sample 3-sigma band around artifacts/README.md's, with
    every step one launch of the env's kernel without emit_final and no
    other kernel launched."""
    from rsoccer_tpu_torch import convert
    from rsoccer_tpu_torch.eval import evaluate_policy
    from rsoccer_tpu_torch.models.sac import make_policy
    from rsoccer_tpu_torch.ops import ssl_full as sf

    task_of = {t.env_id: t for t in ssl_tasks}
    misses = {}
    for name, (env_id, p_ref, n_ref, n_steps) in SAC_REFS.items():
        actor = convert.load_sac_checkpoint(os.path.join(ARTIFACTS, f"{name}.ckpt.npz"), device="cuda")
        tracing.clear_launches()
        t0 = time.perf_counter()
        out = evaluate_policy(env_id, make_policy(actor), n_envs=SAC_EVAL_ENVS, n_steps=n_steps, device="cuda",
                              fused=True)
        secs = time.perf_counter() - t0
        task = task_of[env_id]
        entry = sf.routed_entry(task.entry, SAC_EVAL_ENVS)
        check_launches(f"sac_checkpoint {name}", wrappers, task.wrapper, entry, n_steps, final=0)
        lo, hi = two_sample_band(p_ref, p_ref * (1 - p_ref), n_ref, out["episodes"])
        inside = lo <= out["success_rate"] <= hi
        phase("sac_checkpoint", card=card, checkpoint=f"artifacts/{name}.ckpt.npz", **out,
              reference={"success_rate": p_ref, "episodes": n_ref}, band_3sigma=[lo, hi], inside=inside,
              launches={task.wrapper.__name__: tracing.entry_launches(task.wrapper)}, seconds=secs)
        if not inside:
            misses[name] = (out["success_rate"], [lo, hi])
    if misses:
        raise AssertionError(f"sac_checkpoint: outside the band: {misses}")


# ---- the scripted experts and BC on the card: K4, K6, K7 under a state policy
# env id: (envs, steps, floor); the floors are tests/test_experts.py's
EXPERT_RUNS = {
    "SSLStaticDefenders-v0": (1024, 2000, 0.88),
    "SSLPassEndurance-v0": (1024, 2400, 0.97),
    "SSLDribbling-v0": (256, 5100, 1.0),  # ten 510-step courses (9600 steps until PR 10)
}
SD_EXPERT_REF = (0.967, 1573)  # docs/training.md:347: success rate, episodes
# the JAX package's own SD expert at 1024 envs x 2000 steps on its XLA path
# (seeds 0 and 1, pooled; tests/test_torch_reference_scores.py run as a script)
SD_EXPERT_JAX = (18260 / 19456, 19456)
EXPERT_PROFILE_STEPS = 20
# the pe_bc recipe (artifacts/README.md; docs/training.md "Behavior-cloning
# warm starts"): 512 envs x 512 steps of curriculum resets per round,
# ActorCritic (256, 256) bf16, 40 epochs, minibatch 4096, lr 1e-3, cut to
# 1 DAgger round (the recipe has 2: the third round's collect and
# 786,432-pair fit take ~33 of the ~80-93 s the recipe takes here); then
# the clone's deterministic eval at 256 envs
BC_ARGS = ["--env-id", "SSLPassEndurance-v0", "--dagger-iters", "1", "--eval-steps", "2400",
           "--seed", "0", "--device", "cuda", "--save", os.path.join(OUT_DIR, "pe_bc_port.ckpt")]
BC_FLOOR = 0.90
BC_PROFILE_STEPS = 8  # collect steps under the profiler
# the shipped checkpoints no run of the port had scored, at 1024 envs on
# the fused kernel-RNG path (artifacts/README.md): name: (format, env id,
# steps, success rate, episodes, floor), the rate and count that of the
# JAX package itself where the published one does not reproduce there or
# has no count
BC_CKPT_ENVS = 1024
# sac_sd_cloneseed's published 89.4% of 15,029 does not reproduce on the
# JAX package itself: at these envs and steps its XLA path scores 87.96%
# and 88.32% (seeds 0 and 1; tests/test_torch_reference_scores.py, run as
# a script), both below that number's band. The gate is the band around
# the JAX package's pooled score; the published one is printed beside it.
CLONESEED_JAX = (25548 / 28985, 28985)
# sd_bc, sd_sac_bc and sac_pe_nstep: the JAX package's own scores at these
# envs and steps (seeds 0 and 1, pooled; the same script). sd_bc's
# published 46.7% does not reproduce there (41.62% of 8,307). Their
# published numbers come with no episode count: the band printed beside
# is one-sample, around the published rate at this run's count.
SD_BC_JAX = (3457 / 8307, 8307)
SD_SAC_BC_JAX = (4239 / 9399, 9399)
SAC_PE_NSTEP_JAX = (29075 / 159873, 159873)
BC_CKPT_PUBLISHED = {"sac_sd_cloneseed": (0.894, 15029), "sd_bc": (0.467, None), "sd_sac_bc": (0.470, None),
                     "sac_pe_nstep": (0.176, None)}
BC_CKPT_REFS = {
    "pe_bc": ("ppo", "SSLPassEndurance-v0", 2400, 0.968, 7217, None),
    "pe_rl": ("ppo", "SSLPassEndurance-v0", 2400, 0.908, 69091, None),
    "sac_sd_cloneseed": ("sac", "SSLStaticDefenders-v0", 2400, *CLONESEED_JAX, None),
    "drb_sac": ("sac", "SSLDribbling-v0", 9600, 1.000, 6144, 0.990),
    "sac_pe_nstep": ("sac", "SSLPassEndurance-v0", 2400, *SAC_PE_NSTEP_JAX, None),
    "sd_bc": ("ppo", "SSLStaticDefenders-v0", 2400, *SD_BC_JAX, None),
    "sd_sac_bc": ("sac", "SSLStaticDefenders-v0", 2400, *SD_SAC_BC_JAX, None),
}


def expert_score(card, wrappers, ssl_tasks):
    """Each scripted expert on its reference-exact env at EXPERT_RUNS' size
    on the fused kernel-RNG path: every step is unpack_state -> the expert
    -> one launch of the env's kernel (counts zeroed before, checked
    after); the success rate from eval.make_metrics_fn against the JAX
    test's floor (SD also never into the GK area, with the band around
    the published 96.7% printed beside it; DR's completion step count
    beside the CPU's).  Then the profiler over EXPERT_PROFILE_STEPS steps:
    device µs per step, the kernel's and the expert's alone."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.core.state import tree_map
    from rsoccer_tpu_torch.eval import make_metrics_fn, success_criterion
    from rsoccer_tpu_torch.experts import EXPERTS
    from rsoccer_tpu_torch.ops import ssl_full as sf

    task_of = {t.env_id: t for t in ssl_tasks}
    for env_id, (n, steps, floor) in EXPERT_RUNS.items():
        task = task_of[env_id]
        benv = rt.make_vec(env_id, n, device="cuda", fused=True, fused_rng="kernel")
        expert = EXPERTS[env_id](benv.env)
        metrics_fn = make_metrics_fn(success_criterion(env_id))
        carry = R.init_carry(benv, 0)
        zeros = torch.zeros((n,), device="cuda")
        run = {"state": carry.state, "ep_ret": zeros, "ep_len": zeros.clone(), "total": None,
               "gk": torch.zeros((), device="cuda")}

        def body():
            act = expert(benv.unpack_state(run["state"]))
            run["state"], _, r, term, trunc, info = benv.step(run["state"], act, carry.key)
            done = term | trunc
            ep_ret, ep_len = run["ep_ret"] + r, run["ep_len"] + 1.0
            m = metrics_fn(r, done, ep_ret, ep_len, info)
            run["total"] = m if run["total"] is None else tree_map(torch.add, run["total"], m)
            if "rbt_in_gk_area" in info:
                run["gk"] += (done & (info["rbt_in_gk_area"] > 0.5)).sum()
            run["ep_ret"], run["ep_len"] = torch.where(done, 0.0, ep_ret), torch.where(done, 0.0, ep_len)

        tracing.clear_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            body()
        out = run["total"].summary()  # syncs
        secs = time.perf_counter() - t0
        entry = sf.routed_entry(task.entry, n)
        launches = check_launches(f"expert_score {env_id}", wrappers, task.wrapper, entry, steps, final=0)
        gk = int(run["gk"])
        step_us, top = device_us(body, EXPERT_PROFILE_STEPS)
        kernel_us, _ = device_us(body, EXPERT_PROFILE_STEPS, task.kernel_match)
        view = benv.unpack_state(run["state"])
        expert_us, _ = device_us(lambda: expert(view), EXPERT_PROFILE_STEPS)
        host_ms = secs / steps * 1e3
        extra = {}
        if env_id == "SSLStaticDefenders-v0":
            p, n_ref = SD_EXPERT_REF
            p_jax, n_jax = SD_EXPERT_JAX
            extra = {"gk_area_entries": gk, "published": {"success_rate": p, "episodes": n_ref},
                     "band_3sigma": two_sample_band(p, p * (1 - p), n_ref, out["episodes"]),
                     "jax_cpu": {"success_rate": p_jax, "episodes": n_jax},
                     "jax_cpu_band_3sigma": two_sample_band(p_jax, p_jax * (1 - p_jax), n_jax, out["episodes"])}
        if env_id == "SSLDribbling-v0":
            extra = dr_course_gate("dr_expert", out["mean_episode_length"])
        phase("expert_score", card=card, env_id=env_id, envs=n, steps=steps, **out, floor=floor, **extra,
              seconds=secs, host_ms_per_step=host_ms, device_us_per_step=step_us,
              kernel_device_us_per_step=kernel_us, kernel_share_of_step=kernel_us / (host_ms * 1e3),
              expert_device_us_per_step=expert_us, top_kernels_us_per_step=top, launches=launches,
              entry=entry)
        if out["success_rate"] < floor or gk or not extra.get("course_inside", True):
            raise AssertionError(f"expert_score {env_id}: success {out['success_rate']} (floor {floor}), "
                                 f"GK-area entries {gk}, {extra}")


def bc_train(card, wrappers, ssl_tasks):
    """rsoccer_tpu_torch/tools/bc_warmstart.py in-process at the pe_bc
    recipe (BC_ARGS): collect (unfused curriculum env: no kernel), fit,
    DAgger, the residual std, the checkpoint, and the clone's eval on the
    reference env through K7 (every eval step one launch, counts zeroed
    before the tool and checked after).  Fails on a non-finite MSE, a fit
    whose last epoch is not below its first, or a clone under BC_FLOOR;
    then reloads the checkpoint with convert.load_ppo_checkpoint and
    re-scores it to the same number."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch import convert
    from rsoccer_tpu_torch.eval import evaluate_policy
    from rsoccer_tpu_torch.experts import EXPERTS
    from rsoccer_tpu_torch.models.ppo import make_policy
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.tools import bc_warmstart as bc

    k7 = next(t for t in ssl_tasks if t.env_id == "SSLPassEndurance-v0")
    args = bc.build_parser().parse_args(BC_ARGS)
    tracing.clear_launches()
    t0 = time.perf_counter()
    out = bc.run(args)
    secs = time.perf_counter() - t0
    n_eval = args.eval_steps
    entry = sf.routed_entry(k7.entry, 256)
    launches = check_launches("bc_train", wrappers, k7.wrapper, entry, n_eval, final=0)
    ev = out["eval"]
    path = args.save + ".npz"
    net, obs_norm = convert.load_ppo_checkpoint(path, device="cuda")
    tracing.clear_launches()
    again = evaluate_policy(args.env_id, make_policy(net, obs_norm, deterministic=True), n_envs=256,
                            n_steps=n_eval, seed=9, device="cuda", fused=True)
    check_launches("bc_train reload", wrappers, k7.wrapper, entry, n_eval, final=0)
    # where the collect's and the fit's time goes: a few steps and one
    # epoch under the profiler (tables in chiprun_out/)
    benv = rt.make_vec(args.env_id, args.envs, device="cuda", curriculum=True)
    expert = EXPERTS[args.env_id](benv.env)
    collect_us, collect_top = device_us(lambda: bc.collect(benv, expert, BC_PROFILE_STEPS, 1), 1,
                                        table="profile_bc_collect.txt")
    Xn = obs_norm.normalize(torch.rand((args.minibatch * 8, benv.obs_size), device="cuda") * 2 - 1)
    Y = torch.rand((Xn.shape[0], benv.action_size), device="cuda") * 2 - 1
    fit_us, fit_top = device_us(lambda: bc.fit(net, Xn, Y, [torch.randperm(Xn.shape[0], device="cuda")],
                                               args.lr, args.minibatch), 1, table="profile_bc_fit.txt")
    finite = all(math.isfinite(v) for m in out["mse"] for v in m)
    falling = all(m[-1] < m[0] for m in out["mse"])
    phase("bc_train", card=card, recipe=" ".join(BC_ARGS), pairs_per_round=out["pairs"],
          collect_seconds_per_round=out["collect_s"], fit_ms_per_epoch=out["fit_ms_per_epoch"],
          mse_every_5th_epoch=[m[::5] for m in out["mse"]], last_epoch_mse=[m[-1] for m in out["mse"]],
          residual_std=out["resid_std"], clone_eval=ev, reloaded_eval=again, floor=BC_FLOOR,
          collect_device_us_per_step=collect_us / BC_PROFILE_STEPS,
          collect_host_ms_per_step=[c / args.steps * 1e3 for c in out["collect_s"]],
          collect_top_kernels_us=collect_top, fit_device_us_per_adam_step=fit_us / 8,
          fit_host_ms_per_adam_step=[f / p * args.minibatch for f, p in zip(out["fit_ms_per_epoch"], out["pairs"])],
          fit_top_kernels_us=fit_top,
          checkpoint=path, launches=launches, entry=entry, seconds=secs)
    if not finite or not falling or ev["success_rate"] < BC_FLOOR:
        raise AssertionError(f"bc_train: mse finite {finite}, falling {falling}, clone {ev['success_rate']} "
                             f"(floor {BC_FLOOR})")
    if again["success_rate"] != ev["success_rate"] or again["episodes"] != ev["episodes"]:
        raise AssertionError(f"bc_train: the reloaded checkpoint scores {again}, the clone {ev}")


def bc_checkpoints(card, wrappers, ssl_tasks):
    """The shipped policies of the experts' line that no run of the port
    had scored (BC_CKPT_REFS) through convert (no jax) and
    eval.evaluate_policy (deterministic) at BC_CKPT_ENVS envs on the fused
    kernel-RNG path: each inside the two-sample 3-sigma band around its
    reference (BC_CKPT_REFS), or above its floor where the band is empty,
    with the published band printed beside where the reference is the JAX
    package's; drb_sac's course length inside its gate (DR_COURSE_JAX).
    Every step one launch of the env's kernel without emit_final, no
    other kernel."""
    from rsoccer_tpu_torch import convert
    from rsoccer_tpu_torch.eval import evaluate_policy
    from rsoccer_tpu_torch.models import ppo, sac
    from rsoccer_tpu_torch.ops import ssl_full as sf

    task_of = {t.env_id: t for t in ssl_tasks}
    misses = {}
    for name, (fmt, env_id, n_steps, p_ref, n_ref, floor) in BC_CKPT_REFS.items():
        path = os.path.join(ARTIFACTS, f"{name}.ckpt.npz")
        if fmt == "sac":
            policy = sac.make_policy(convert.load_sac_checkpoint(path, device="cuda"))
        else:
            policy = ppo.make_policy(*convert.load_ppo_checkpoint(path, device="cuda"), deterministic=True)
        tracing.clear_launches()
        t0 = time.perf_counter()
        out = evaluate_policy(env_id, policy, n_envs=BC_CKPT_ENVS, n_steps=n_steps, device="cuda", fused=True)
        secs = time.perf_counter() - t0
        task = task_of[env_id]
        entry = sf.routed_entry(task.entry, BC_CKPT_ENVS)
        launches = check_launches(f"bc_checkpoints {name}", wrappers, task.wrapper, entry, n_steps, final=0)
        band, inside, extra = None, None, {}
        if p_ref is not None:
            lo, hi = two_sample_band(p_ref, p_ref * (1 - p_ref), n_ref, out["episodes"])
            band = [min(lo, floor) if floor is not None else lo, hi]
            inside = band[0] <= out["success_rate"] <= band[1]
            if not inside:
                misses[name] = (out["success_rate"], band)
        if name in BC_CKPT_PUBLISHED:
            p_pub, n_pub = BC_CKPT_PUBLISHED[name]
            if n_pub is None:  # no count published: the one-sample band at this run's count
                half = 3.0 * math.sqrt(p_pub * (1 - p_pub) / max(out["episodes"], 1))
                lo, hi = p_pub - half, p_pub + half
            else:
                lo, hi = two_sample_band(p_pub, p_pub * (1 - p_pub), n_pub, out["episodes"])
            extra = {"published": {"success_rate": p_pub, "episodes": n_pub}, "published_band_3sigma": [lo, hi],
                     "inside_published_band": lo <= out["success_rate"] <= hi}
        if name in DR_COURSE_JAX:
            extra = dr_course_gate(name, out["mean_episode_length"])
            if not extra["course_inside"]:
                misses[name] = (out["mean_episode_length"], extra["course_band"])
        phase("bc_checkpoint", card=card, checkpoint=f"artifacts/{name}.ckpt.npz", format=fmt, **out,
              reference=None if p_ref is None else {"success_rate": p_ref, "episodes": n_ref},
              band_3sigma=band, floor=floor, inside=inside, **extra, launches=launches, entry=entry,
              seconds=secs)
    if misses:
        raise AssertionError(f"bc_checkpoints: outside the band: {misses}")


# ---- multi-agent and self-play on the card: K2 under policies that score
MA_ID, SP_ID = "VSSMultiAgent-v0", "VSSSelfPlay-v0"
# the round-5 self-play recipe (docs/training.md "Self-play (3v3)": 2048
# envs, towers (256, 256) bf16, 128 rollout steps, time minibatches, half
# the lanes OU, anchor gate), cut to SELFPLAY_UPDATES updates with a swap
# every 3 (20 with a swap every 5 before the data-parallel phases came,
# then 10; 6 since the one-thread VSS kernels' build grew the script), and
# its evals
# cut from 1200 steps x 512 envs (vs the frozen opponent) and 1500 x 512
# (the anchor) to fit the script's time
SELFPLAY_UPDATES = 6
SELFPLAY_ARGS = ["--envs", "2048", "--updates", str(SELFPLAY_UPDATES), "--swap-every", "3",
                 "--rollout-steps", "128", "--minibatch-mode", "time", "--ou-frac", "0.5", "--anchor-gate",
                 "--eval-steps", "300", "--eval-envs", "512", "--anchor-envs", "512", "--anchor-steps", "300",
                 "--hidden", "256,256", "--device", "cuda", "--seed", "0"]
# the league policies on the VSSMultiAgent-v0 anchor (tools/vss_anchor_eval:
# 1024 envs x 4800 steps, deterministic, seed 123): artifacts/README.md's
# numbers (blue goal rate, episodes, yellow goal rate, goal diff), and the
# JAX package's own at that size (tests/test_torch_reference_scores.py, run
# as a script; it reproduces r3's 9,568 episodes, and the mix's 6,580 at
# 512 envs x 3600 steps)
LEAGUE_ENVS, LEAGUE_STEPS = 1024, 4800
LEAGUE_REFS = {"selfplay_vss_r3": (0.634, 9568, 0.092, 0.54), "selfplay_vss_mix": (0.873, 6580, 0.045, 0.83)}
LEAGUE_JAX = {"selfplay_vss_r3": (0.6335702341137124, 9568, 0.09165969899665552, 0.5419105351170569),
              "selfplay_vss_mix": (0.8648972602739726, 17520, 0.048515981735159815, 0.8163812785388128)}


def physics_record(name, k2, env, state, launches: int, err: float) -> dict:
    """The physics kernel's record for the kernels line: device time per
    launch and its plain version's on ``state`` (structured, at its own
    batch), its bound, the launches of the run it served."""
    calls = physics_calls(k2, env, SimpleNamespace(state=state))
    kern_us, _ = device_us(calls["kernel"], TIMED_LAUNCHES, k2.kernel_match)
    plain_us, _ = device_us(calls["plain"], 10)
    bound, by, _, _ = bound_ms(calls["ins"], calls["kernel"](), k2.ops_env, k2.ops_reset, 0)
    return {"name": name, "route": "cuda", "source": k2.source, "replaces": k2.replaces,
            "launches": launches, "max_abs_err": err, "ms": kern_us / 1e3, "plain_ms": plain_us / 1e3,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def selfplay_train(card, wrappers, k2, err):
    """examples/selfplay_vss.run in-process at SELFPLAY_ARGS (the adapter on
    ``fused_physics``: K2 under the learner's blues and the frozen net's or
    the OU lanes' yellows), every launch count zeroed before and read
    after: one launch of K2's group kernel per env step of the collects,
    the evals against the frozen opponent and the anchor, and no other
    kernel.  Prints each swap (goal rate against the frozen opponent, the
    anchor, promoted or not, collect and update ms).  Returns (trainer,
    state, the kernel's record)."""
    from rsoccer_tpu_torch.examples import selfplay_vss as spx
    from rsoccer_tpu_torch.ops import vss_physics as vp

    args = spx.build_parser().parse_args(SELFPLAY_ARGS)
    tracing.clear_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = spx.run(args, on_swap=lambda rec: phase("selfplay_swap", card=card, **rec))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    hist = out["history"]
    n_swaps = args.updates // args.swap_every
    n = args.updates * args.rollout_steps + n_swaps * (args.eval_steps + args.anchor_steps)
    launches = check_launches("selfplay_train", wrappers, vp.vss_physics, "vss_physics_step", n)
    trainer, state = out["trainer"], out["state"]
    finite = all(math.isfinite(r[k]) for r in hist for k in ("goalrate_vs_frozen", "anchor_goal_rate",
                                                               "mean_reward", "collect_ms", "update_ms"))
    per_update = {k: sum(r[k] for r in hist) / len(hist) for k in ("collect_ms", "update_ms")}
    phase("selfplay_train", card=card, args=" ".join(SELFPLAY_ARGS), swaps=len(hist), seconds=secs,
          launches=launches, entry="vss_physics_step", k2_launches_want=n,
          collect_ms_per_update=per_update["collect_ms"], update_ms_per_update=per_update["update_ms"],
          collect_ms_per_step=per_update["collect_ms"] / args.rollout_steps,
          env_steps_per_s_in_updates=args.rollout_steps * args.envs / (sum(per_update.values()) / 1e3),
          goalrate_vs_frozen=[r["goalrate_vs_frozen"] for r in hist],
          anchor=[r["anchor_goal_rate"] for r in hist], promoted=[r["promoted"] for r in hist],
          best_anchor=out["best"]["anchor"])
    if len(hist) != n_swaps or not finite:
        raise AssertionError(f"selfplay_train: {len(hist)} swaps of {n_swaps}, finite {finite}: {hist}")
    rec = physics_record(f"vss_physics_kernel (self-play: PPO collect at {args.envs} envs, evals)", k2,
                         trainer.benv.env, state.env_state[0], launches["vss_physics"], err)
    return trainer, state, rec


def selfplay_resume(trainer, state):
    """The whole self-play state, the frozen opponent's payload included,
    saved and restored; one more update from each: the same params, env
    state (the payload's leaves too), key and loss, bit for bit."""
    from rsoccer_tpu_torch.utils import checkpoint

    path = os.path.join(OUT_DIR, "selfplay_resume.ckpt")
    checkpoint.save(path, trainer.state_tree(state))
    size = os.path.getsize(path + ".npz")
    back = trainer.state_from_tree(checkpoint.restore(path, like=trainer.state_tree(state)))
    os.remove(path + ".npz")
    s1, m1 = trainer.train_step(state)
    s2, m2 = trainer.train_step(back)
    torch.cuda.synchronize()
    same = {
        "params": bit_equal(list(s1.net.parameters()), list(s2.net.parameters())),
        "env_state": bit_equal(checkpoint.flatten(s1.env_state), checkpoint.flatten(s2.env_state)),
        "payload_leaves": len(checkpoint.flatten(s1.env_state[1])),
        "env_key": torch.equal(s1.env_key, s2.env_key),
        "loss": bool(torch.equal(m1["loss"], m2["loss"])),
    }
    phase("selfplay_resume", bytes=size, after_one_update_equal=same, update_step=s2.update_step)
    if not all(v for k, v in same.items() if k != "payload_leaves"):
        raise AssertionError(f"selfplay_resume: after one more update {same}")


def selfplay_checkpoint(card, wrappers, k2, err):
    """The league policies through convert (no jax) on the VSSMultiAgent-v0
    anchor (tools/vss_anchor_eval) through K2 at LEAGUE_ENVS x
    LEAGUE_STEPS, seed 123: each blue goal rate inside the two-sample
    3-sigma band around its published number, with the goal diff and the
    JAX package's bands beside it; every step one launch of K2's group
    kernel, no other kernel.  Returns the kernel's record."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch import convert
    from rsoccer_tpu_torch.models.ppo import make_policy
    from rsoccer_tpu_torch.ops import vss_physics as vp
    from rsoccer_tpu_torch.ops.philox import make_key
    from rsoccer_tpu_torch.tools.vss_anchor_eval import anchor_eval

    misses, total = {}, 0
    for name, ref in LEAGUE_REFS.items():
        net, obs_norm = convert.load_ppo_checkpoint(os.path.join(ARTIFACTS, f"{name}.ckpt.npz"), device="cuda")
        benv = rt.make_vec(MA_ID, LEAGUE_ENVS, device="cuda", fused_physics=True)
        tracing.clear_launches()
        t0 = time.perf_counter()
        out = anchor_eval(benv, make_policy(net, obs_norm, deterministic=True), LEAGUE_STEPS, seed=123)
        secs = time.perf_counter() - t0
        launches = check_launches(f"selfplay_checkpoint {name}", wrappers, vp.vss_physics, "vss_physics_step",
                                  LEAGUE_STEPS)
        total += launches["vss_physics"]
        bands = goal_bands(ref, out["episodes"])
        jax_bands = goal_bands(LEAGUE_JAX[name], out["episodes"])
        lo, hi = bands["blue_goal_rate"]
        inside = lo <= out["blue_goal_rate"] <= hi
        phase("selfplay_checkpoint", card=card, checkpoint=f"artifacts/{name}.ckpt.npz", env_id=MA_ID,
              envs=LEAGUE_ENVS, steps=LEAGUE_STEPS, **out,
              published={"blue_goal_rate": ref[0], "episodes": ref[1], "yellow_goal_rate": ref[2],
                         "mean_goal_diff": ref[3]}, band_3sigma=bands, inside=inside,
              goal_diff_inside=bands["mean_goal_diff"][0] <= out["mean_goal_diff"] <= bands["mean_goal_diff"][1],
              jax_cpu={"blue_goal_rate": LEAGUE_JAX[name][0], "episodes": LEAGUE_JAX[name][1],
                       "mean_goal_diff": LEAGUE_JAX[name][3]}, jax_cpu_band_3sigma=jax_bands,
              launches=launches, entry="vss_physics_step", seconds=secs,
              host_ms_per_step=secs / LEAGUE_STEPS * 1e3)
        if not inside:
            misses[name] = (out["blue_goal_rate"], [lo, hi])
    if misses:
        raise AssertionError(f"selfplay_checkpoint: outside the band: {misses}")
    # K2 at the anchor's batch, on a league state
    benv = rt.make_vec(MA_ID, LEAGUE_ENVS, device="cuda", fused_physics=True)
    st, _ = benv.reset(make_key(5, device="cuda"))
    return physics_record(f"vss_physics_kernel (league anchor, {LEAGUE_ENVS} envs)", k2, benv.env, st, total, err)


# ---- the gymnasium wrappers' numpy core on the card (batch/host.py).
# gymnasium and pygame do not import on the card's machine: GymnasiumEnv,
# VectorGymnasiumEnv, the renderer and the GIF export are held by the CPU
# tests (tests/test_torch_gym_compat.py, test_torch_frame_render.py,
# test_torch_video_examples.py); here runs what they stand on.
GYM_TASKS = ("vss_full_step", "ssl_sd_full_step", "ssl_cp_full_step", "ssl_dr_full_step", "ssl_pe_full_step")
GYM_GATE_STEPS, GYM_GATE_LIMIT = 6, 3  # every env truncates at steps 3 and 6
GYM_WARM_STEPS = 5
GYM_TIMED_STEPS = 100
GYM_PROFILE_STEPS = 10
GYM_SINGLE_CHECK_STEPS = 5
GYM_SINGLE_STEPS = 300
HOST_VIEW_ENVS = (0, 1, B // 2, B - 1)
HOST_VIEW_CALLS = 200
CUSTOM_ENV_STEPS = 60  # the course touches the ball at step 21


def vector_step_err(got, want, tag):
    """Two HostVectorEnv steps (obs, reward, terminated, truncated, infos):
    obs, reward, info and final_obs within ATOL, the flags and the SAME_STEP
    masks exactly.  Returns (largest error, the envs that reset)."""
    import numpy as np

    if not (np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3])):
        raise AssertionError(f"{tag}: terminated or truncated differ")
    if sorted(got[4]) != sorted(want[4]):
        raise AssertionError(f"{tag}: info keys {sorted(got[4])} against {sorted(want[4])}")
    errs = [float(np.abs(got[0] - want[0]).max()), float(np.abs(got[1] - want[1]).max())]
    done = np.zeros(len(want[0]), bool)
    for k, v in want[4].items():
        if k in ("final_obs", "final_info"):
            continue
        if k.startswith("_final"):
            if not np.array_equal(got[4][k], v):
                raise AssertionError(f"{tag}: the {k} masks differ")
        else:
            errs.append(float(np.abs(got[4][k] - v).max()))
    if "_final_obs" in want[4]:
        done = want[4]["_final_obs"]
        idx = np.nonzero(done)[0]
        errs.append(float(np.abs(np.stack(list(got[4]["final_obs"][idx]))
                                 - np.stack(list(want[4]["final_obs"][idx]))).max()))
    err = max(errs)
    if not err <= ATOL:
        raise AssertionError(f"{tag}: fused vs plain beyond {ATOL}: {err}")
    return err, done


def gym_vector(card, wrappers, task):
    """HostVectorEnv (what VectorGymnasiumEnv steps) at B envs with kernel
    RNG.  Gate: fused=True against fused=False on the card from one seed
    (both draw one Philox stream: the same trajectory) over GYM_GATE_STEPS
    steps at a step limit of GYM_GATE_LIMIT, set on the env before the
    first step (the kernel reads it from the env's params): obs, reward,
    info and final_obs within ATOL, flags and masks exactly, every env
    through a SAME_STEP reset, and the fused side one launch of the task's
    emit_final variant per step, through the C entry its route names, and
    no other launch.  Then the user's rate at the normal step limit: host
    ms per step, the kernel's device us, the step's device time, the bytes
    copied to the host, env-steps/s, and the step split into the batched
    step alone (synced), the one copy and the rest (actions up, object
    arrays).  Returns the timed HostVectorEnv."""
    import numpy as np

    from rsoccer_tpu_torch.batch import host
    from rsoccer_tpu_torch.ops.philox import make_key

    entry = routed_entry(task, B)
    fused = host.HostVectorEnv(task.env_id, B, fused=True, fused_rng="kernel")
    plain = host.HostVectorEnv(task.env_id, B, fused=False)
    fused.env.max_episode_steps = plain.env.max_episode_steps = GYM_GATE_LIMIT
    rng = np.random.default_rng(11)
    acts = [rng.uniform(-1, 1, (B, fused.env.action_size)).astype(np.float32) for _ in range(8)]
    tracing.clear_launches()
    err = float(np.abs(fused.reset(seed=5)[0] - plain.reset(seed=5)[0]).max())
    reset_seen = np.zeros(B, bool)
    for t in range(GYM_GATE_STEPS):
        e, done = vector_step_err(fused.step(acts[t]), plain.step(acts[t]), f"gym_vector_{task.name} step {t}")
        err, reset_seen = max(err, e), reset_seen | done
    gate_launches = check_launches(f"gym_vector_{task.name}", wrappers, task.wrapper, entry,
                                   GYM_GATE_STEPS, final=GYM_GATE_STEPS)
    if not err <= ATOL or not reset_seen.all():
        raise AssertionError(f"gym_vector_{task.name}: reset obs err {err}, "
                             f"{int(reset_seen.sum())} of {B} envs reset")

    env = host.HostVectorEnv(task.env_id, B, fused=True, fused_rng="kernel")
    env.reset(seed=1)
    for t in range(GYM_WARM_STEPS):
        env.step(acts[t % len(acts)])
    tracing.clear_launches()
    dones = 0
    t0 = time.perf_counter()
    for t in range(GYM_TIMED_STEPS):
        obs, _, term, trunc, _ = env.step(acts[t % len(acts)])
        dones += int((term | trunc).sum())
    host_s = time.perf_counter() - t0
    launches = check_launches(f"gym_vector_{task.name} timed", wrappers, task.wrapper, entry,
                              GYM_TIMED_STEPS, final=GYM_TIMED_STEPS)
    if obs.shape != (B, env.env.obs_size) or not np.isfinite(obs).all() or np.abs(obs).max() > np.float32(1.2):
        raise AssertionError(f"gym_vector_{task.name}: obs not finite, of the wrong shape or outside +-1.2")
    ms = host_s * 1e3 / GYM_TIMED_STEPS
    # the same step without the host side: the batched step alone, synced
    benv, st, key = env.benv, env.state, make_key(2, device="cuda")
    act_t = torch.from_numpy(np.ascontiguousarray(acts[0].T)).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GYM_TIMED_STEPS):
        out = benv.step_final(st, act_t, key)
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / GYM_TIMED_STEPS
    rows = [out[1], out[2], out[3], out[4], out[5], *out[6].values()]
    t0 = time.perf_counter()
    for _ in range(GYM_TIMED_STEPS):
        host.to_host(rows)
    copy_ms = (time.perf_counter() - t0) * 1e3 / GYM_TIMED_STEPS
    kern_us, dev_us, top = device_us_split(lambda: env.step(acts[0]), GYM_PROFILE_STEPS, task.kernel_match)
    phase(f"gym_vector_{task.name}", card=card, env=task.env_id, B=B, entry=entry,
          gate={"steps": GYM_GATE_STEPS, "step_limit": GYM_GATE_LIMIT, "max_abs_err": err, "atol": ATOL,
                "envs_reset": int(reset_seen.sum()), "launches": gate_launches[task.wrapper.__name__]},
          steps=GYM_TIMED_STEPS, launches=launches[task.wrapper.__name__],
          host_ms_per_step=ms, env_steps_per_s=B / (ms / 1e3), bytes_to_host_per_step=env.host_bytes,
          done_envs_per_step=dones / GYM_TIMED_STEPS, kernel_device_us=kern_us,
          device_us_per_step=dev_us, device_busy_share=dev_us / (ms * 1e3),
          batched_step_synced_ms=step_ms, copy_to_host_ms=copy_ms,
          rest_ms=ms - step_ms - copy_ms, top_kernels_us_per_step=top)
    return env


def gym_single_vss(card, wrappers):
    """HostEnv("VSS-v0") (what GymnasiumEnv and gym.make step) on the card
    against the same on the CPU: same seed, same actions, GYM_SINGLE_CHECK_STEPS
    steps, obs, reward and info within ATOL and the flags exactly; then host
    ms per step over GYM_SINGLE_STEPS steps.  The single env runs the plain
    step (as the JAX package's GymnasiumEnv, which jits the env's step and
    never reaches Pallas): no kernel launches."""
    import numpy as np

    from rsoccer_tpu_torch.batch.host import HostEnv

    card_env, cpu_env = HostEnv("VSS-v0"), HostEnv("VSS-v0", device="cpu")
    err = float(np.abs(card_env.reset(seed=4)[0] - cpu_env.reset(seed=4)[0]).max())
    rng = np.random.default_rng(12)
    acts = rng.uniform(-1, 1, (GYM_SINGLE_STEPS, 2)).astype(np.float32)
    for t in range(GYM_SINGLE_CHECK_STEPS):
        got, want = card_env.step(acts[t]), cpu_env.step(acts[t])
        if got[2:4] != want[2:4] or sorted(got[4]) != sorted(want[4]):
            raise AssertionError(f"gym_single_vss step {t}: flags or info keys differ")
        err = max(err, float(np.abs(got[0] - want[0]).max()), abs(got[1] - want[1]),
                  *(abs(got[4][k] - want[4][k]) for k in want[4]))
    if not err <= ATOL:
        raise AssertionError(f"gym_single_vss: card vs CPU beyond {ATOL}: {err}")
    card_env.reset(seed=5)
    tracing.clear_launches()
    t0 = time.perf_counter()
    for t in range(GYM_SINGLE_STEPS):
        obs, reward, term, trunc, info = card_env.step(acts[t])
        if term or trunc:
            card_env.reset()
    ms = (time.perf_counter() - t0) * 1e3 / GYM_SINGLE_STEPS
    launches = {w.__name__: tracing.launches(w) for w in wrappers}
    if any(launches.values()) or not np.isfinite(obs).all():
        raise AssertionError(f"gym_single_vss: launches {launches}, obs finite {np.isfinite(obs).all()}")
    phase("gym_single_vss", card=card, check_steps=GYM_SINGLE_CHECK_STEPS, max_abs_err=err, atol=ATOL,
          steps=GYM_SINGLE_STEPS, host_ms_per_step=ms, steps_per_s=1e3 / ms, launches=launches)


def host_views(card, gym_envs):
    """frame_from_batched of a few envs of the card's packed K1 and K4
    states (the timed HostVectorEnvs', through unpack_state) against
    frame_from_world of the same env copied to the CPU: every field equal;
    host ms per frame.  Both read the SAME unpacked state: on DR the fused
    path's infrared (recomputed from the kicker face by unpack_state) is
    not the unfused state's on the reset state, so a fused frame is never
    compared with an unfused one."""
    import dataclasses

    from rsoccer_tpu_torch.core.frame import frame_from_batched, frame_from_world
    from rsoccer_tpu_torch.core.state import tree_map

    out = {}
    for name, env in gym_envs.items():
        nb, ny = env.env.n_blue, env.env.n_yellow
        world = env.benv.unpack_state(env.state).world
        for i in HOST_VIEW_ENVS:
            got = dataclasses.asdict(frame_from_batched(world, i, nb, ny))
            want = dataclasses.asdict(frame_from_world(tree_map(lambda t: t[..., i:i + 1].cpu(), world), nb, ny))
            if got != want:
                raise AssertionError(f"host_views {name} env {i}: {got} != {want}")
        t0 = time.perf_counter()
        for j in range(HOST_VIEW_CALLS):
            frame_from_batched(world, HOST_VIEW_ENVS[j % len(HOST_VIEW_ENVS)], nb, ny)
        out[name] = (time.perf_counter() - t0) * 1e3 / HOST_VIEW_CALLS
    phase("host_views", card=card, envs=list(HOST_VIEW_ENVS), host_ms_per_frame=out)


def custom_env(card, wrappers):
    """examples/custom_env.py's ReachBallEnv at B envs on the card through
    BatchedEnv's plain path (a custom task has no fused kernel): every env
    touches the ball at the step the CPU run of the same function gives,
    and no kernel launches."""
    from rsoccer_tpu_torch.examples import custom_env as ce

    want = ce.touch_steps(16, device="cpu", max_steps=CUSTOM_ENV_STEPS).unique().tolist()
    tracing.clear_launches()
    t0 = time.perf_counter()
    got = ce.touch_steps(B, max_steps=CUSTOM_ENV_STEPS).cpu()
    secs = time.perf_counter() - t0
    launches = {w.__name__: tracing.launches(w) for w in wrappers}
    touched = got.unique().tolist()
    phase("custom_env", card=card, B=B, steps=CUSTOM_ENV_STEPS, touch_step=touched, touch_step_cpu=want,
          host_ms_per_step=secs * 1e3 / CUSTOM_ENV_STEPS, launches=launches)
    if len(want) != 1 or want[0] < 0 or touched != want or any(launches.values()):
        raise AssertionError(f"custom_env: the card's touch steps {touched}, the CPU's {want}, launches {launches}")


# ---- data parallelism (rsoccer_tpu_torch/parallel/): env_base through the
# kernels, the sharded rollout, PPO and SAC at two ranks (gloo, two
# processes sharing this card) against one rank (nccl, this process), and
# the elastic-resume tool
PAR_STEPS = ROLLOUT_STEPS  # VSS-v0 at B global envs, kernel RNG
PAR_WORLD = 2
PAR_PPO = dict(hidden=(256, 256), rollout_steps=32, num_epochs=2, num_minibatches=4)  # the gate, f32 towers
PAR_PPO_UPDATES = 2
PAR_SAC_ITERS = 50  # the SD recipe at SAC_ENVS global envs
PAR_TIMEOUT = 300  # seconds, each worker rank
ELASTIC_ARGS = ["--updates", "6", "--every", "2", "--envs", "256", "--fused"]
ELASTIC_CRASH_AT = 3


def env_base_kernels(card, tasks):
    """K1, K4-K7 with kernel RNG on a shard at env_base B/2 (B/2 envs),
    N_CHECK_STEPS steps at a step limit of 3 (every env resets, drawing its
    spawn words): each step against its plain version at the same env_base
    (ATOL), and, bit for bit, against those columns of the unsharded
    batch's kernel step.  One phase per kernel; returns the errors."""
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.ops.philox import make_key

    half, errs = B // 2, {}
    for task in (t for t in tasks if t.name in GYM_TASKS):
        env = make_env(task)
        env.max_episode_steps = 3
        full = BatchedEnv(env, B, device="cuda", fused=True, fused_rng="kernel")
        shard = BatchedEnv(env, half, device="cuda", fused=True, fused_rng="kernel", env_base=half)
        kf, ks = make_key(11, device="cuda"), make_key(11, device="cuda")
        st_f, obs = full.reset(kf)
        st_s, _ = shard.reset(ks)
        same = bit_equal((st_s,), (st_f[:, half:].contiguous(),))
        gen = torch.Generator(device="cuda").manual_seed(5)
        worst, dones = 0.0, 0
        for t in range(N_CHECK_STEPS):
            act = task.actions(obs, gen)
            act_s = act[:, half:].contiguous()
            rows = task.draw(env, ks.clone(), half, half)
            got = task.wrapper(env, st_s, act_s, key=ks, emit_final=True, env_base=half)
            want = task.plain(env, st_s, act_s, *rows, True)
            err, _ = compare_step(env.n_robots, got, want, f"{task.name} env_base={half} step={t}")
            worst = max(worst, err)
            full_out = task.wrapper(env, st_f, act, key=kf, emit_final=True)
            same = same and bit_equal(got, tuple(x[:, half:].contiguous() for x in full_out))
            dones += int(((got[2][1] > 0.5) | (got[2][2] > 0.5)).sum())
            st_s, st_f, obs = got[0], full_out[0], full_out[1][:env.obs_size]
        torch.cuda.synchronize()
        phase(f"kernel_vs_plain_env_base_{task.name}", card=card, B=half, env_base=half, steps=N_CHECK_STEPS,
              max_abs_err=worst, atol=ATOL, dones=dones, bit_equal_to_unsharded_columns=same)
        if not same or dones == 0:
            raise AssertionError(f"{task.name} at env_base {half}: bit equal to the unsharded columns {same}, "
                                 f"dones {dones}")
        errs[task.name] = worst
    return errs


def par_rollout_side(mesh, wrappers) -> dict:
    """One rank of the sharded VSS-v0 rollout (B global envs, kernel RNG):
    the gated call (launch counts zeroed before), a timed call after a
    barrier, a profiled local rollout (busy share), a timed call at B envs
    per rank (W B global: weak scaling); then the shard_map variant's one
    call."""
    import torch.distributed as dist

    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops.philox import fold_in
    from rsoccer_tpu_torch.parallel.mesh import batch_slice, local_benv
    from rsoccer_tpu_torch.parallel.rollout import (
        make_shard_map_rollout, make_sharded_rollout, shard_carry, sharded_uniform_policy,
    )

    benv = rt.make_vec("VSS-v0", B, device=mesh.device, fused=True, fused_rng="kernel")
    roll, init = make_sharded_rollout(benv, mesh, PAR_STEPS)
    carry = init(0)
    torch.cuda.synchronize()
    tracing.clear_launches()
    carry, ms = roll(carry)
    torch.cuda.synchronize()
    lbenv = local_benv(benv, mesh)
    out = {"launches": check_launches(f"parallel_rollout rank {mesh.rank} of {mesh.world}", wrappers,
                                      vf.vss_full_step, vss_entry(lbenv), PAR_STEPS),
           "route": vf.route(benv.env, lbenv.n_envs), "state": carry.state.cpu(), "obs": carry.obs.cpu(),
           "metrics": torch.stack([m.double() for m in ms]).cpu()}
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    carry, ms = roll(carry)
    torch.cuda.synchronize()
    out["us_per_step"] = (time.perf_counter() - t0) * 1e6 / PAR_STEPS
    local = R.make_rollout_fn(lbenv, PROFILE_ROLLOUT_STEPS,
                              policy=sharded_uniform_policy(2, B, batch_slice(mesh, B)))
    dev_us, _ = device_us(lambda: local(carry), 1)
    out["device_us_per_step"] = dev_us / PROFILE_ROLLOUT_STEPS
    out["busy_share"] = out["device_us_per_step"] / out["us_per_step"]
    # weak scaling: B envs per rank (W B global), timed only
    roll_w, init_w = make_sharded_rollout(rt.make_vec("VSS-v0", B * mesh.world, device=mesh.device, fused=True,
                                                      fused_rng="kernel"), mesh, PAR_STEPS)
    c_w, _ = roll_w(init_w(0))
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    roll_w(c_w)
    torch.cuda.synchronize()
    out["weak_us_per_step"] = (time.perf_counter() - t0) * 1e6 / PAR_STEPS
    roll_sm = make_shard_map_rollout(benv, mesh, PAR_STEPS)
    c_sm = shard_carry(R.init_carry(benv, 0), mesh)
    out["shard_key"] = fold_in(c_sm.key, mesh.rank)[:2].tolist()
    c_sm, ms_sm = roll_sm(c_sm)
    out["shard_map_metrics"] = torch.stack([m.double() for m in ms_sm]).cpu()
    out["shard_map_obs"] = c_sm.obs.cpu()
    out["shard_map_key"] = c_sm.key.cpu()
    return out


def par_ppo_side(mesh) -> dict:
    """One rank of the sharded PPO on VSS-v0 at B global envs (K1's
    emit_final): the gate (PAR_PPO, f32 towers, PAR_PPO_UPDATES updates) in
    both minibatch modes, then the bf16 recipe (PPO_CONFIG) timed."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer
    from rsoccer_tpu_torch.tools.distributed_smoke import (
        global_abs_sum, param_checksum, param_digest, params_equal_across_ranks,
    )

    benv = rt.make_vec("VSS-v0", B, device=mesh.device, fused=True, fused_rng="kernel")
    out = {}
    for mode in ("shuffle", "time"):
        trainer = PPOTrainer(benv, PPOConfig(**PAR_PPO, minibatch_mode=mode), mesh=mesh)
        state = trainer.init(0)
        state.net.compute_dtype = torch.float32
        for _ in range(PAR_PPO_UPDATES):
            state, m = trainer.train_step(state)
        out[mode] = {"loss": float(m["loss"]), "mean_reward": float(m["mean_reward"]),
                     "param_checksum": param_checksum([state.net]), "param_digest": param_digest([state.net]),
                     "params_equal_across_ranks": params_equal_across_ranks([state.net], mesh),
                     "obs_sum": global_abs_sum(state.obs, mesh)}
    trainer = PPOTrainer(benv, PPOConfig(**PPO_CONFIG), mesh=mesh)
    state = trainer.init(0)
    out["bf16"] = []
    for _ in range(PAR_PPO_UPDATES):
        state, m = trainer.train_step(state)
        out["bf16"].append(trainer.phase_ms())
    return out


def par_sac_side(mesh, wrappers, k4) -> dict:
    """One rank of the sharded SAC: the SD recipe at SAC_ENVS global envs
    (K4's emit_final on the rank's shard), PAR_SAC_ITERS iterations timed
    (launch counts zeroed before), then K4 alone on the rank's last state."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.models.sac import SACConfig, make_policy
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops.philox import make_key
    from rsoccer_tpu_torch.parallel.sac import make_sharded_sac
    from rsoccer_tpu_torch.tools.distributed_smoke import param_digest, params_equal_across_ranks

    benv = rt.make_vec("SSLStaticDefenders-v0", SAC_ENVS, device=mesh.device, fused=True, fused_rng="kernel")
    local, init, step = make_sharded_sac(benv, SACConfig(**SAC_CONFIG), mesh)
    state = init(0)
    torch.cuda.synchronize()
    tracing.clear_launches()
    t0 = time.perf_counter()
    for i in range(PAR_SAC_ITERS):
        state, m = step(state, 0, i)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = check_launches(f"parallel_sac rank {mesh.rank} of {mesh.world}", wrappers, sf.sd_full_step,
                              sf.routed_entry("ssl_sd_full_step", local.benv.n_envs), PAR_SAC_ITERS,
                              final=PAR_SAC_ITERS)
    nets = [state.actor, state.qs, state.qs_target]
    env, lb = local.benv.env, local.benv
    act = make_policy(state.actor, deterministic=False)(torch.Generator(device=mesh.device).manual_seed(7), state.obs)
    key = make_key(3, device=mesh.device)
    k4_us, _ = device_us(lambda: sf.sd_full_step(env, state.env_state, act, key=key, emit_final=True,
                                                 env_base=lb.env_base), TIMED_LAUNCHES, k4.kernel_match)
    return {"launches": launches, "iters_per_s": PAR_SAC_ITERS / secs,
            "metrics": {k: float(v) for k, v in m.items()}, "filled": state.buffer.filled,
            "local_envs": lb.n_envs, "param_digest": param_digest(nets),
            "params_equal_across_ranks": params_equal_across_ranks(nets, mesh), "k4_us_per_launch": k4_us}


def parallel_worker(rank: int, world: int, store: str, out: str) -> int:
    """A worker rank of the parallel phases (``--parallel-worker``): gloo
    over this card, the three sides, the results to ``out``."""
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp
    from rsoccer_tpu_torch.parallel import mesh as M

    tasks = make_tasks()
    wrappers = [vf.vss_full_step, vp.vss_physics, sf.sd_full_step, sf.cp_full_step, sf.dr_full_step,
                sf.pe_full_step]
    k4 = next(t for t in tasks if t.name == "ssl_sd_full_step")
    M.initialize_distributed("gloo", f"file://{store}", world, rank)
    try:
        mesh = M.make_env_mesh("cuda")
        res = {"rollout": par_rollout_side(mesh, wrappers), "ppo": par_ppo_side(mesh),
               "sac": par_sac_side(mesh, wrappers, k4)}
    finally:
        torch.distributed.destroy_process_group()
    torch.save(res, out)
    return 0


def parallel_phases(card, wrappers, k4):
    """parallel_rollout, parallel_ppo, parallel_sac: the worker ranks
    (PAR_WORLD processes, gloo, this card) run first, alone on the card;
    then one nccl rank in this process, and the unsharded counterparts.
    Gates: the ranks' rollout states and obs, concatenated, equal the
    unsharded rollout's bit for bit (metrics to rel 1e-6), K1 once per
    step per rank; PPO at two ranks within rel 1e-4 (loss, param
    checksum) and 1e-5 (obs) of one rank, its params bit-identical across
    the ranks; SAC's networks bit-identical across the ranks, each ring
    holding iterations x local envs, finite losses; every one-rank run
    over nccl equal to its unsharded counterpart bit for bit."""
    import shutil

    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer
    from rsoccer_tpu_torch.models.sac import SACConfig, SACTrainer, iteration_generator
    from rsoccer_tpu_torch.parallel import mesh as M
    from rsoccer_tpu_torch.tools.distributed_smoke import param_digest

    work = os.path.join(OUT_DIR, "parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    outs = [os.path.join(work, f"rank{r}.pt") for r in range(PAR_WORLD)]
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(PAR_WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-worker", str(r),
                               str(PAR_WORLD), os.path.abspath(os.path.join(work, "store2")), outs[r]],
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(PAR_WORLD)]
    try:
        for r, p in enumerate(procs):
            if p.wait(timeout=PAR_TIMEOUT) != 0:
                raise AssertionError(f"parallel worker rank {r} exited {p.returncode}: see {work}/rank{r}.log")
    finally:
        for p in procs:
            p.kill()
        for f in logs:
            f.close()
    ranks = [torch.load(o, weights_only=False) for o in outs]
    workers_s = time.perf_counter() - t0

    M.initialize_distributed("nccl", f"file://{os.path.abspath(os.path.join(work, 'store1'))}", 1, 0)
    try:
        mesh = M.make_env_mesh("cuda")
        one = {"rollout": par_rollout_side(mesh, wrappers), "ppo": par_ppo_side(mesh),
               "sac": par_sac_side(mesh, wrappers, k4)}
    finally:
        torch.distributed.destroy_process_group()

    # ---- parallel_rollout
    benv = rt.make_vec("VSS-v0", B, device="cuda", fused=True, fused_rng="kernel")
    carry, ms = R.make_rollout_fn(benv, PAR_STEPS)(R.init_carry(benv, 0))
    want = (carry.state.cpu(), carry.obs.cpu())
    want_ms = torch.stack([m.double() for m in ms]).cpu()
    gate = {}
    for tag, sides in (("w2_gloo", [r["rollout"] for r in ranks]), ("w1_nccl", [one["rollout"]])):
        got = (torch.cat([s["state"] for s in sides], -1), torch.cat([s["obs"] for s in sides], -1))
        rel = max(float((s["metrics"] - want_ms).abs().max() / want_ms.abs().max()) for s in sides)
        gate[tag] = {"bit_equal": bit_equal(got, want), "metrics_rel_err": rel}
        if not gate[tag]["bit_equal"] or rel > 1e-6:
            raise AssertionError(f"parallel_rollout {tag}: {gate[tag]}")
    w2 = [r["rollout"] for r in ranks]
    sm_keys = [r["rollout"]["shard_key"] for r in ranks]
    sm = {"shard_keys": sm_keys, "distinct_draws": sm_keys[0] != sm_keys[1],
          "shards_differ_from_sharded_rollout": not torch.equal(ranks[1]["rollout"]["shard_map_obs"], want[1][:, B // 2:]),
          "metrics_summed": ranks[0]["rollout"]["shard_map_metrics"].tolist(),
          "key_replicated": torch.equal(ranks[0]["rollout"]["shard_map_key"], ranks[1]["rollout"]["shard_map_key"])}
    phase("parallel_rollout", card=card, env="VSS-v0", B=B, steps=PAR_STEPS, gate=gate,
          w2_us_per_step=[s["us_per_step"] for s in w2], w1_us_per_step=one["rollout"]["us_per_step"],
          w2_env_steps_per_s=B * 1e6 / max(s["us_per_step"] for s in w2),
          w1_env_steps_per_s=B * 1e6 / one["rollout"]["us_per_step"],
          w2_busy_share=[s["busy_share"] for s in w2], w1_busy_share=one["rollout"]["busy_share"],
          w2_weak_us_per_step=[s["weak_us_per_step"] for s in w2],
          w2_weak_env_steps_per_s=PAR_WORLD * B * 1e6 / max(s["weak_us_per_step"] for s in w2),
          w2_device_us_per_step=[s["device_us_per_step"] for s in w2],
          w1_device_us_per_step=one["rollout"]["device_us_per_step"],
          k1_launches_per_rank=[s["launches"]["vss_full_step"] for s in w2], route=w2[0]["route"],
          shard_map=sm, workers_s=workers_s)
    if not (sm["distinct_draws"] and sm["shards_differ_from_sharded_rollout"] and sm["key_replicated"]):
        raise AssertionError(f"parallel_rollout shard_map: {sm}")

    # ---- parallel_ppo
    ppo = {}
    for mode in ("shuffle", "time"):
        trainer = PPOTrainer(benv, PPOConfig(**PAR_PPO, minibatch_mode=mode))
        state = trainer.init(0)
        state.net.compute_dtype = torch.float32
        for _ in range(PAR_PPO_UPDATES):
            state, _ = trainer.train_step(state)
        a, b = ranks[0]["ppo"][mode], one["ppo"][mode]
        rels = {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in ("loss", "param_checksum", "obs_sum")}
        ppo[mode] = {"w2": a, "w1": b, "rel": rels,
                     "w2_ranks_equal": all(r["ppo"][mode]["param_digest"] == a["param_digest"] for r in ranks)
                     and a["params_equal_across_ranks"],
                     "w1_equals_plain": b["param_digest"] == param_digest([state.net])}
        if not (rels["loss"] <= 1e-4 and rels["param_checksum"] <= 1e-4 and rels["obs_sum"] <= 1e-5
                and ppo[mode]["w2_ranks_equal"] and ppo[mode]["w1_equals_plain"]):
            raise AssertionError(f"parallel_ppo {mode}: {ppo[mode]}")
    bf16 = {"w2": [r["ppo"]["bf16"] for r in ranks], "w1": one["ppo"]["bf16"]}
    last = {k: [r["ppo"]["bf16"][-1][k] for r in ranks] for k in ("collect_ms", "update_ms")}
    bf16["w2_minus_w1_ms_last_update"] = {k: max(v) - one["ppo"]["bf16"][-1][k] for k, v in last.items()}
    phase("parallel_ppo", card=card, env="VSS-v0", B=B, config={**PAR_PPO, "hidden": list(PAR_PPO["hidden"])},
          updates=PAR_PPO_UPDATES, gate=ppo, bf16_recipe=bf16)

    # ---- parallel_sac
    sd = rt.make_vec("SSLStaticDefenders-v0", SAC_ENVS, device="cuda", fused=True, fused_rng="kernel")
    trainer = SACTrainer(sd, SACConfig(**SAC_CONFIG))
    state = trainer.init(0)
    for i in range(PAR_SAC_ITERS):
        state, _ = trainer.train_step(state, iteration_generator(0, i))
    sides = [r["sac"] for r in ranks]
    sac = {"w2_ranks_equal": all(s["param_digest"] == sides[0]["param_digest"] for s in sides)
           and sides[0]["params_equal_across_ranks"],
           "w2_filled": [s["filled"] for s in sides], "w2_local_envs": [s["local_envs"] for s in sides],
           "w1_equals_plain": one["sac"]["param_digest"] == param_digest([state.actor, state.qs, state.qs_target]),
           "finite": all(math.isfinite(v) for s in (*sides, one["sac"]) for v in s["metrics"].values())}
    phase("parallel_sac", card=card, env="SSLStaticDefenders-v0", B=SAC_ENVS, iters=PAR_SAC_ITERS, gate=sac,
          w2_iters_per_s=[s["iters_per_s"] for s in sides], w1_iters_per_s=one["sac"]["iters_per_s"],
          w2_k4_us_per_launch=[s["k4_us_per_launch"] for s in sides],
          w1_k4_us_per_launch=one["sac"]["k4_us_per_launch"],
          w2_metrics=sides[0]["metrics"], w1_metrics=one["sac"]["metrics"],
          w2_param_digests=[s["param_digest"] for s in sides], w1_param_digest=one["sac"]["param_digest"])
    if not (sac["w2_ranks_equal"] and sac["w1_equals_plain"] and sac["finite"]
            and all(f == PAR_SAC_ITERS * SAC_ENVS // PAR_WORLD for f in sac["w2_filled"])):
        raise AssertionError(f"parallel_sac: {sac}")


def elastic_resume(card, wrappers):
    """tools/elastic_train.py for PPO (VSS-v0, K1) and SAC (VSS-v0, K1) on
    the card's fused path, in this process: uninterrupted, crashed before
    update ELASTIC_CRASH_AT (SystemExit 1), resumed; the digests equal."""
    from rsoccer_tpu_torch.tools import elastic_train

    out = {}
    for algo in ("ppo", "sac"):
        base = os.path.join(OUT_DIR, f"elastic_{algo}")
        common = [*ELASTIC_ARGS, "--algo", algo]
        t0 = time.perf_counter()
        ref = elastic_train.main([*common, "--ckpt", base + "_a"])
        try:
            elastic_train.main([*common, "--ckpt", base + "_b", "--crash-at", str(ELASTIC_CRASH_AT)])
            raise AssertionError(f"elastic_resume {algo}: the simulated crash did not happen")
        except SystemExit as e:
            if e.code != 1:
                raise
        with open(base + "_b.meta.json") as f:
            saved = json.load(f)["update"]
        got = elastic_train.main([*common, "--ckpt", base + "_b", "--resume"])
        out[algo] = {"digest": ref["digest"], "resumed_digest": got["digest"], "snapshot_at_crash": saved,
                     "seconds": time.perf_counter() - t0}
        for suffix in ("_a", "_b"):
            os.remove(base + suffix + ".npz")
        if got["digest"] != ref["digest"]:
            raise AssertionError(f"elastic_resume {algo}: {out[algo]}")
    phase("elastic_resume", card=card, args=ELASTIC_ARGS, crash_at=ELASTIC_CRASH_AT, runs=out)


# ---- the tools (rsoccer_tpu_torch/tools/), each in-process through its
# main(argv) on the card, every launch count zeroed just before and read
# just after
TOOL_DIR = os.path.join(OUT_DIR, "tools")
BENCH_IDS = ("VSS-v0", "SSLStaticDefenders-v0", "SSLDribbling-v0", "SSLContestedPossession-v0",
             "SSLPassEndurance-v0")
BENCH_STEPS = 20  # the tool's default 100 (the plain path's points take ~2 s each at 20)
BENCH_TIMED = 2  # timed calls (the tool's default: from 5, grown to a 2 s window)
PROFILE_STEP_STEPS = 20  # the tool's default 100
PROFILE_PPO_ENVS, PROFILE_PPO_ITERS = 4096, 2  # the tool's default iters 5
PROFILE_SAC_CHAIN = 20  # the tool's default 200 (the tool's default iters 5: 1 here)
# the JAX docstring's 50 and 200; SAC's 25 puts the profiled window past
# the 50 warmup collects of its two warm-up calls
ROOFLINE_CHAIN = {"ppo": 1, "sac": 25}
# The JAX tool's own output on its XLA path, on the CPU, at the size the
# phase runs: `JAX_PLATFORMS=cpu python tools/sd_spawn_slice.py --params
# artifacts/sd_ppo3.ckpt --envs 1024 --steps 2000` (episodes, goal rate)
SPAWN_ENVS, SPAWN_STEPS = 1024, 2000
SPAWN_JAX = {
    "by_defender_dist": {"<0.3": (748, 0.7620320855614974), "0.3-0.6": (3146, 0.8312142403051493),
                         "0.6-1.0": (5015, 0.8753738783649053), "1.0-2.0": (7618, 0.8972171173536361),
                         ">=2.0": (1836, 0.8986928104575164)},
    "by_ball_x": {"0.2-1": (3739, 0.8210751537844343), "1-2": (4683, 0.8641896220371557),
                  "2-3": (4730, 0.9010570824524313), "3-4": (3992, 0.9183366733466933),
                  "4-4.4": (1219, 0.8326497128794094)},
}
SPAWN_JAX_TOTAL = (18363, 0.8745847628383162)
# docs/training.md:128-134: the published slice (2048 episodes of an 87.1%
# policy; the ball at x >= 4.0 m: 0.792)
SPAWN_PUBLISHED = {"<0.3": (78, 0.654), "0.3-0.6": (328, 0.784), "0.6-1.0": (593, 0.862),
                   "1.0-2.0": (828, 0.882), ">=2.0": (221, 0.950)}


def check_counts(tag, wrappers, want: dict):
    """After a run that began with ``tracing.clear_launches()``: each wrapper
    named in ``want`` (its ``__name__`` -> (C entry, launches, emit_final
    launches)) launched that often, all through that entry; every other
    wrapper never.  Returns the launch counts."""
    launches = {w.__name__: tracing.launches(w) for w in wrappers}
    for w in wrappers:
        entry, n, final = want.get(w.__name__, (None, 0, 0))
        by_entry = tracing.entry_launches(w)
        finals = tracing.launches(w, final=True)
        if launches[w.__name__] != n or by_entry != ({entry: n} if n else {}) or finals != final:
            raise AssertionError(f"{tag}: {w.__name__} launched {launches[w.__name__]} by entry {by_entry}, "
                                 f"emit_final {finals}; want {n} through {entry}, emit_final {final}")
    return launches


def kernel_launches(summary: dict, match: str) -> int:
    """Launches in a profiled window of the kernels ``match`` finds."""
    return sum(c for name, (_, c) in summary["kernels"].items() if re.search(match, name))


def tool_bench_all(card, wrappers, tasks):
    """tools/bench_all.py over the five ids at B envs in modes 0, full and
    full-krng, then VSS-v0 in mode 1: every fused point one launch of its
    env's routed entry per env step (2 warm-up and BENCH_TIMED timed calls
    of BENCH_STEPS steps), no other launch."""
    from rsoccer_tpu_torch.tools import bench_all

    task_of = {t.env_id: t for t in tasks if t.name in GYM_TASKS}
    per_point = (2 + BENCH_TIMED) * BENCH_STEPS
    args = ["--envs", str(B), "--steps", str(BENCH_STEPS), "--iters", str(BENCH_TIMED), "--min-seconds", "0"]
    t0 = time.perf_counter()
    tracing.clear_launches()
    rows = bench_all.main(["--ids", ",".join(BENCH_IDS), "--modes", "0,full,full-krng", *args,
                           "--out", os.path.join(TOOL_DIR, "bench_all.json")])
    want = {task_of[i].wrapper.__name__: (routed_entry(task_of[i], B), 2 * per_point, 0) for i in BENCH_IDS}
    launches = check_counts("tool_bench_all", wrappers, want)
    tracing.clear_launches()
    rows += bench_all.main(["--ids", "VSS-v0", "--modes", "1", *args,
                            "--out", os.path.join(TOOL_DIR, "bench_all_mode1.json")])
    check_counts("tool_bench_all mode 1", wrappers, {"vss_physics": ("vss_physics_step", per_point, 0)})
    bad = [r for r in rows if not (math.isfinite(r["value"]) and r["value"] > 0)]
    if bad or len(rows) != 3 * len(BENCH_IDS) + 1:
        raise AssertionError(f"tool_bench_all: rows {rows}")
    phase("tool_bench_all", card=card, B=B, cut=f"--steps {BENCH_STEPS} (100), --min-seconds 0 (2.0), "
          f"--iters {BENCH_TIMED} (5)", launches=launches, vss_physics_launches=per_point,
          env_steps_per_s={f"{r['env_id']} {r['mode']}": r["value"] for r in rows}, timer=rows[0]["timer"],
          seconds=time.perf_counter() - t0)


def tool_profiles(card, wrappers, k1, k4):
    """tools/profile_step.py (VSS-v0 full-krng at B envs), profile_ppo.py
    (SD at PROFILE_PPO_ENVS, fused, kernel RNG) and profile_sac.py (SD at
    SAC_ENVS, fused, kernel RNG), each checked by its launches: one of the
    routed entry per env step (the learners' the emit_final variant), and
    the profiled window's."""
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.tools import profile_ppo, profile_sac, profile_step

    t0 = time.perf_counter()
    tracing.clear_launches()
    out = profile_step.main(["--env-id", "VSS-v0", "--envs", str(B), "--steps", str(PROFILE_STEP_STEPS),
                             "--mode", "full-krng", "--out", os.path.join(TOOL_DIR, "profile_step")])
    check_launches("tool_profile_step", wrappers, vf.vss_full_step, "vss_full_step",
                   (2 + out["calls_run"]) * PROFILE_STEP_STEPS, final=0)
    in_window = kernel_launches(out, k1.kernel_match)
    if in_window != PROFILE_STEP_STEPS:
        raise AssertionError(f"tool_profile_step: K1 launched {in_window} times in the window")
    phase("tool_profile_step", card=card, B=B, steps=PROFILE_STEP_STEPS, cut="--steps 20 (100)",
          k1_launches_in_window=in_window, busy_share=out["busy_share"], device_us=out["total_us"],
          top=out["top"][:6], trace=out["trace"], seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    tracing.clear_launches()
    out = profile_ppo.main(["--envs", str(PROFILE_PPO_ENVS), "--fused", "--fused-rng", "kernel",
                            "--iters", str(PROFILE_PPO_ITERS), "--out", os.path.join(TOOL_DIR, "profile_ppo")])
    n = (2 + PROFILE_PPO_ITERS + out["trace"]["calls_run"]) * 128  # warm-up, timed, profiled updates
    entry = sf.routed_entry("ssl_sd_full_step", PROFILE_PPO_ENVS)
    check_launches("tool_profile_ppo", wrappers, sf.sd_full_step, entry, n, final=n)
    in_window = kernel_launches(out["trace"], k4.kernel_match)
    if in_window != 128:
        raise AssertionError(f"tool_profile_ppo: K4 launched {in_window} times in the window")
    phase("tool_profile_ppo", card=card, B=PROFILE_PPO_ENVS, cut=f"--iters {PROFILE_PPO_ITERS} (5)",
          emit_final_launches=n, k4_launches_in_window=in_window,
          **{k: out[k] for k in ("timer", "ms_per_update", "env_steps_per_s", "phase_ms")},
          busy_share=out["trace"]["busy_share"], device_ms=out["trace"]["total_us"] / 1e3,
          top=out["trace"]["top"][:6], seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    tracing.clear_launches()
    out = profile_sac.main(["--envs", str(SAC_ENVS), "--fused", "--fused-rng", "kernel", "--chain",
                            str(PROFILE_SAC_CHAIN), "--iters", "1", "--out", os.path.join(TOOL_DIR, "profile_sac")])
    n = (2 + 1 + out["trace"]["calls_run"]) * PROFILE_SAC_CHAIN
    check_launches("tool_profile_sac", wrappers, sf.sd_full_step, sf.routed_entry("ssl_sd_full_step", SAC_ENVS),
                   n, final=n)
    in_window = kernel_launches(out["trace"], k4.kernel_match)
    if in_window != PROFILE_SAC_CHAIN:
        raise AssertionError(f"tool_profile_sac: K4 launched {in_window} times in the window")
    phase("tool_profile_sac", card=card, B=SAC_ENVS, cut=f"--chain {PROFILE_SAC_CHAIN} (200), --iters 1 (5)",
          emit_final_launches=n, k4_launches_in_window=in_window,
          **{k: out[k] for k in ("timer", "us_per_iter", "env_steps_per_s")},
          busy_share=out["trace"]["busy_share"], device_ms=out["trace"]["total_us"] / 1e3,
          top=out["trace"]["top"][:6], seconds=time.perf_counter() - t0)


def tool_rooflines(card, wrappers):
    """tools/roofline.py on the JAX docstring's two runs, chains cut (and
    SAC's on the fused path, as PPO's: K4 kernel RNG): the matmul FLOPs the
    profiler counts equal the towers' count from their shapes, the MFU is
    at most 100%, the classes sum to the device total, K4 once per env
    step through the emit_final variant."""
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.tools import roofline

    runs = {"ppo": (["--envs", "4096", "--num-epochs", "2", "--minibatch-mode", "time"], 4096, 128),
            "sac": (["--envs", str(SAC_ENVS)], SAC_ENVS, 1)}
    for learner, (extra, b, steps) in runs.items():
        t0 = time.perf_counter()
        chain = ROOFLINE_CHAIN[learner]
        tracing.clear_launches()
        out = roofline.main(["--learner", learner, *extra, "--chain", str(chain), "--fused", "--fused-rng",
                             "kernel", "--out", os.path.join(TOOL_DIR, f"roofline_{learner}"),
                             "--json", os.path.join(TOOL_DIR, f"roofline_{learner}.json")])
        n = (2 + out["calls_run"]) * chain * steps  # two warm-up calls and the profiler's
        check_launches(f"tool_roofline_{learner}", wrappers, sf.sd_full_step,
                       sf.routed_entry("ssl_sd_full_step", b), n, final=n)
        class_ms = sum(v["ms"] for v in out["by_category"].values())
        total_ms = out["us_per_iter"] * chain / 1e3
        gates = {"matmul_flops_equal": out["matmul_flops"] == out["matmul_flops_towers"],
                 "mfu_at_most_100": out["mfu_pct"] <= 100.0,
                 "classes_sum_to_total": abs(class_ms - total_ms) <= 1e-9 * total_ms,
                 "env_launches_in_window": out["env_kernel"]["launches"] == chain * steps}
        phase(f"tool_roofline_{learner}", card=card, B=b, cut=f"--chain {chain} (JAX docstring: "
              f"{ {'ppo': 50, 'sac': 200}[learner]})", emit_final_launches=n, gates=gates,
              **{k: out[k] for k in ("us_per_iter", "env_steps_per_s", "busy_share", "matmul_flops",
                                     "matmul_flops_towers", "achieved_tflops", "gemm_tflops", "towers_dtype",
                                     "peak_tflops", "mfu_pct", "by_category", "env_kernel")},
              seconds=time.perf_counter() - t0)
        if not all(gates.values()):
            raise AssertionError(f"tool_roofline_{learner}: {gates}")


def tool_sd_spawn_slice(card, wrappers):
    """tools/sd_spawn_slice.py with sd_ppo3 on K4 (fused, kernel RNG) at
    the JAX tool's size: each defender-distance and ball-x bin's goal rate
    inside the two-sample 3-sigma band around the JAX tool's own output;
    one K4 launch per step, no other launch."""
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.tools import sd_spawn_slice

    t0 = time.perf_counter()
    tracing.clear_launches()
    out = sd_spawn_slice.main(["--params", os.path.join(ARTIFACTS, "sd_ppo3.ckpt"), "--envs", str(SPAWN_ENVS),
                               "--steps", str(SPAWN_STEPS), "--fused"])
    check_launches("tool_sd_spawn_slice", wrappers, sf.sd_full_step,
                   sf.routed_entry("ssl_sd_full_step", SPAWN_ENVS), SPAWN_STEPS, final=0)
    bins, misses = {}, {}
    for table, refs in SPAWN_JAX.items():
        for label, (n_ref, p_ref) in refs.items():
            got = out[table][label]
            band = two_sample_band(p_ref, p_ref * (1 - p_ref), n_ref, got["episodes"])
            bins[f"{table} {label}"] = {"episodes": got["episodes"], "goal_rate": got["goal_rate"],
                                        "jax": [n_ref, p_ref], "band_3sigma": band}
            if not band[0] <= got["goal_rate"] <= band[1]:
                misses[f"{table} {label}"] = bins[f"{table} {label}"]
    phase("tool_sd_spawn_slice", card=card, envs=SPAWN_ENVS, steps=SPAWN_STEPS, episodes=out["episodes"],
          goal_rate=out["goal_rate"], jax_total=SPAWN_JAX_TOTAL, bins=bins,
          published_by_defender_dist=SPAWN_PUBLISHED,
          termination_modes=out["termination_modes_by_defender_dist"], inside=not misses,
          seconds=time.perf_counter() - t0)
    if misses:
        raise AssertionError(f"tool_sd_spawn_slice: outside the band: {misses}")


# the physics calibration (tools/calibrate.py) on the card: the self-test at
# the JAX tool's size, then a fit at a log's size (8192 transitions)
CAL_RTOL = 1e-4  # the card's first loss and gradients against the CPU's
CAL_FIT_ENVS, CAL_FIT_STEPS, CAL_FIT_ITERS = 256, 32, 20
# iterations of the profiled fit: the profiler's own cost per launch (~1500
# launches an iteration) dominates a longer window
CAL_PROFILE_ITERS = 2
# the C++ oracles (ops/native.py): K2 at 3v3 and 5v5, the plain SSL physics
ORACLE_B, ORACLE_SSL_B, ORACLE_STEPS = 8192, 1024, 20


def calibrate_selftest(card):
    """``tools/calibrate.py``'s self-test at the JAX tool's size (6
    robots, T = 80, 300 iterations from its perturbed start) on
    ``device``: the loss falls below 1e-3 of the first, ``robot_accel``
    within 0.3 and ``ball_friction_decel`` within 0.1 of the truth
    (tests/test_calibrate.py's bounds); the first loss and gradients
    within rel ``CAL_RTOL`` of the same on the CPU (a gradient below one
    float32 ulp of the largest, rounding noise, only below that ulp)."""
    from rsoccer_tpu_torch.core.state import tree_map
    from rsoccer_tpu_torch.physics.config import VSS_PHYSICS
    from rsoccer_tpu_torch.tools import calibrate as cal

    device = "cuda"
    states, cmds, field = cal.synthetic_trajectory(device=device)
    bad = cal.perturbed()
    loss, grads = cal.value_and_grad(states, cmds, field, cal.DT, bad, device=device)
    host = [tree_map(lambda t: t.cpu(), x) for x in (states, cmds)]
    c_loss, c_grads = cal.value_and_grad(*host, field, cal.DT, bad, device="cpu")
    loss_rel = abs(float(loss) - float(c_loss)) / abs(float(c_loss))
    mismatches = cal.grad_mismatches(grads, c_grads, CAL_RTOL)
    if not loss_rel <= CAL_RTOL or mismatches:
        raise AssertionError(f"calibrate: first loss {float(loss)} vs the CPU's {float(c_loss)} (rel {loss_rel}), "
                             f"gradients off the CPU's: {mismatches}")
    t0 = time.perf_counter()
    fitted, losses = cal.fit_vss_physics(states, cmds, field, cal.DT, init_cfg=bad, n_iters=300, device=device)
    fit_s = time.perf_counter() - t0
    errs = {k: abs(getattr(fitted, k) - getattr(VSS_PHYSICS, k)) for k in cal.TUNABLE}
    if not (losses[-1] < 1e-3 * losses[0] and errs["robot_accel"] < 0.3 and errs["ball_friction_decel"] < 0.1):
        raise AssertionError(f"calibrate: loss {losses[0]} -> {losses[-1]}, fitted {fitted}")
    phase("calibrate_selftest", card=card, n_robots=6, T=80, iters=300,
          loss_first=losses[0], loss_last=losses[-1], loss_cpu=float(c_loss), loss_rel_err=loss_rel,
          grads={k: float(v) for k, v in grads.items()}, grads_cpu={k: float(v) for k, v in c_grads.items()},
          fitted={k: getattr(fitted, k) for k in cal.TUNABLE}, abs_err=errs,
          host_ms_per_iter=fit_s * 1e3 / 300)


def calibrate_timed_fit(card):
    """A fit at a log's size: ``CAL_FIT_ENVS`` x ``CAL_FIT_STEPS`` = 8192
    transitions of the 3v3 field from random worlds under uniform wheel
    commands through the port's plain step, ``CAL_FIT_ITERS`` iterations
    from the self-test's start: ms per iteration (CUDA events), device us
    per iteration and the busy share (``tools/_trace.py``)."""
    from rsoccer_tpu_torch.core.field import vss_field
    from rsoccer_tpu_torch.core.state import VSSCommands, make_world, tree_map
    from rsoccer_tpu_torch.physics.config import VSS_PHYSICS
    from rsoccer_tpu_torch.physics.vss import make_vss_step
    from rsoccer_tpu_torch.tools import calibrate as cal

    field, n, e, device = vss_field(0), 6, CAL_FIT_ENVS, "cuda"
    gen = torch.Generator(device=device).manual_seed(11)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    xl, yl = field.half_length - field.rbt_radius, field.half_width - field.rbt_radius
    w = make_world(n, batch=e, device=device)
    w = w._replace(
        ball=w.ball._replace(x=uniform(-xl, xl, e), y=uniform(-yl, yl, e),
                             v_x=uniform(-1.5, 1.5, e), v_y=uniform(-1.5, 1.5, e)),
        robots=w.robots._replace(x=uniform(-xl, xl, n, e), y=uniform(-yl, yl, n, e),
                                 theta=uniform(-math.pi, math.pi, n, e)),
    )
    step = make_vss_step(field, VSS_PHYSICS, cal.DT)
    states, cmds = [w], []
    for _ in range(CAL_FIT_STEPS):
        cmds.append(VSSCommands(uniform(-30, 30, n, e), uniform(-30, 30, n, e)))
        states.append(step(states[-1], cmds[-1]))
    stack = lambda *ls: torch.stack(ls, dim=-1)  # noqa: E731  time last, after the envs
    states, cmds = tree_map(stack, *states), tree_map(stack, *cmds)
    bad = cal.perturbed()

    def fit(n_iters=CAL_FIT_ITERS):
        return cal.fit_vss_physics(states, cmds, field, cal.DT, init_cfg=bad, n_iters=n_iters, device=device)

    _, losses = fit()
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"calibrate timed fit: losses {losses}")
    ms = _trace.time_calls(fit, 1, device) * 1e3 / CAL_FIT_ITERS
    trace = _trace.profile(lambda: fit(CAL_PROFILE_ITERS), 1, None, device)
    top = [{**k, "name": k["name"][:80]} for k in trace.top(5)]
    phase("calibrate_timed_fit", card=card, transitions=e * CAL_FIT_STEPS, envs=e,
          steps=CAL_FIT_STEPS, iters=CAL_FIT_ITERS, loss_first=losses[0], loss_last=losses[-1],
          ms_per_iter=ms, profiled_iters=CAL_PROFILE_ITERS,
          device_us_per_iter=trace.total_us / CAL_PROFILE_ITERS,
          launches_per_iter=sum(c for _, c in trace.kernels.values()) / CAL_PROFILE_ITERS,
          busy_share=trace.busy_share, events=trace.events, timer=trace.timer, top=top)


def oracle_vss_worlds(field, n: int, batch: int, gen, device):
    """Batch-last VSS worlds on ``field`` in three scenes by env (as
    tests/test_torch_physics_vss.py's): everyone crowded around the ball;
    the ball in or at the goal pockets, half of it in the air; the ball and
    the robots pressed against the walls."""
    from rsoccer_tpu_torch.core.state import make_world

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    def side(*shape):
        return torch.where(torch.rand(shape, generator=gen, device=device) < 0.5, -1.0, 1.0)

    hl, hw, r = field.half_length, field.half_width, field.rbt_radius
    scene = torch.arange(batch, device=device) % 3
    cx, cy = uniform(-0.5 * hl, 0.5 * hl, batch), uniform(-0.5 * hw, 0.5 * hw, batch)
    crowd_x, crowd_y = cx + uniform(-0.12, 0.12, n, batch), cy + uniform(-0.12, 0.12, n, batch)
    s = side(batch)
    pocket_bx = s * uniform(hl - 0.05, hl + field.goal_depth - field.ball_radius, batch)
    pocket_by = uniform(-field.goal_width / 2, field.goal_width / 2, batch)
    pocket_rx, pocket_ry = s * uniform(hl - 0.2, hl - r, n, batch), uniform(-0.45 * hw, 0.45 * hw, n, batch)
    wall_bx, wall_by = uniform(-hl + 0.01, hl - 0.01, batch), side(batch) * uniform(hw - 0.05, hw, batch)
    wall_rx, wall_ry = side(n, batch) * uniform(hl - 0.15, hl, n, batch), uniform(-hw + r, hw - r, n, batch)
    pick = lambda a, b, c: torch.where(scene == 0, a, torch.where(scene == 1, b, c))  # noqa: E731
    air = (scene == 1) & (torch.rand(batch, generator=gen, device=device) < 0.5)
    w = make_world(n, batch=batch, device=device, ball_radius=field.ball_radius)
    return w._replace(
        ball=w.ball._replace(
            x=pick(cx, pocket_bx, wall_bx), y=pick(cy, pocket_by, wall_by),
            z=field.ball_radius + torch.where(air, uniform(0.0, 0.3, batch), 0.0),
            v_x=uniform(-1.5, 1.5, batch), v_y=uniform(-1.5, 1.5, batch),
            v_z=torch.where(air, uniform(-1.0, 2.0, batch), 0.0)),
        robots=w.robots._replace(
            x=pick(crowd_x, pocket_rx, wall_rx), y=pick(crowd_y, pocket_ry, wall_ry),
            theta=uniform(-math.pi, math.pi, n, batch), v_x=uniform(-0.8, 0.8, n, batch),
            v_y=uniform(-0.8, 0.8, n, batch), v_theta=uniform(-8, 8, n, batch)),
    )


def oracle_ssl_worlds(field, n: int, batch: int, gen, device):
    """Batch-last SSL worlds and commands in four scenes by env (as
    tests/test_torch_physics_ssl.py's): velocity targets, wheel targets,
    the ball on robot 0's kicker face under kicks, and under its dribbler."""
    from rsoccer_tpu_torch.core.state import SSLCommands, make_world

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    scene = torch.arange(batch, device=device) % 4
    w = make_world(n, batch=batch, device=device, ball_radius=field.ball_radius)
    x, y = uniform(-1.0, 1.0, n, batch), uniform(-0.8, 0.8, n, batch)
    theta = uniform(-math.pi, math.pi, n, batch)
    vx, vy, vth = uniform(-1, 1, n, batch), uniform(-1, 1, n, batch), uniform(-6, 6, n, batch)
    bx, by = uniform(-1.0, 1.0, batch), uniform(-0.8, 0.8, batch)
    bvx, bvy = uniform(-2, 2, batch), uniform(-2, 2, batch)
    face = scene >= 2  # kick (2) and dribble (3): the ball on robot 0's face, the others away
    lx = torch.where(scene == 2, uniform(0.100, 0.112, batch), uniform(0.113, 0.140, batch))
    ly = uniform(-0.03, 0.03, batch)
    c0, s0 = torch.cos(theta[0]), torch.sin(theta[0])
    bx = torch.where(face, x[0] + lx * c0 - ly * s0, bx)
    by = torch.where(face, y[0] + lx * s0 + ly * c0, by)
    bvx = torch.where(face, vx[0] + uniform(-0.3, 0.3, batch), bvx)
    bvy = torch.where(face, vy[0] + uniform(-0.3, 0.3, batch), bvy)
    vth = torch.cat([torch.where(face, uniform(-1, 1, batch), vth[0])[None], vth[1:]])
    away = torch.cat([torch.zeros(1, batch, device=device), torch.full((n - 1, batch), 2.5, device=device)])
    x, y = x + face * away, y + face * away
    world = w._replace(
        ball=w.ball._replace(x=bx, y=by, v_x=bvx, v_y=bvy),
        robots=w.robots._replace(x=x, y=y, theta=theta, v_x=vx, v_y=vy, v_theta=vth),
    )

    def commands():
        v_theta = uniform(-8, 8, n, batch)
        v_theta = torch.cat([torch.where(face, uniform(-2, 2, batch), v_theta[0])[None], v_theta[1:]])
        kick = scene == 2
        return SSLCommands(
            wheel_speed=(scene == 1).expand(n, batch).clone(),
            v_wheel=uniform(-60, 60, n, 4, batch), v_x=uniform(-2, 2, n, batch), v_y=uniform(-2, 2, n, batch),
            v_theta=v_theta,
            kick_v_x=torch.where(kick, uniform(-1, 5, n, batch), 0.0),
            kick_v_z=torch.where(kick & (torch.rand(n, batch, generator=gen, device=device) < 0.5),
                                 uniform(0, 3, n, batch), 0.0),
            dribbler=(scene == 3).expand(n, batch).clone(),
        )

    return world, commands


def native_oracle(card, wrappers):
    """K2 (``vss_physics``) at ``ORACLE_B`` envs, 3v3 and 5v5, and the
    port's plain SSL physics at ``ORACLE_SSL_B`` envs, each held against
    the C++ oracle (``ops/native.batched_*_oracle``) on every one of
    ``ORACLE_STEPS`` steps, both started from the same state (the kernel's
    or the plain step's last), to the protocol of tests/test_native_oracle.py
    (2e-4 on ball and robots, 5e-3 on wheel speeds, infrared exact).  K2's
    launches are counted: one per step through its routed entry."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.core.state import VSSCommands
    from rsoccer_tpu_torch.ops import native
    from rsoccer_tpu_torch.ops import vss_physics as vp
    from rsoccer_tpu_torch.physics.ssl import make_ssl_step

    def walk(step, oracle, world, commands, tag):
        worst, oracle_s = {}, 0.0
        for t in range(ORACLE_STEPS):
            cmd = commands()
            got = step(world, cmd)
            t0 = time.perf_counter()
            want = oracle(world, cmd)
            oracle_s += time.perf_counter() - t0
            errs = native.world_errors(got, want)
            native.check_oracle(errs, f"{tag} step {t}")
            worst = {k: max(v, worst.get(k, 0)) for k, v in errs.items()}
            world = got
        return worst, oracle_s

    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(21)
    for cname, kwargs in (("3v3", {}), ("5v5", VSS_CONFIGS["5v5"])):
        env = rt.make("VSS-v0", **kwargs)
        n, f = env.n_robots, env.field
        world = oracle_vss_worlds(f, n, ORACLE_B, gen, device)

        def commands():
            return VSSCommands(*(torch.rand((2, n, ORACLE_B), generator=gen, device=device) * 100.0 - 50.0))

        tracing.clear_launches()
        worst, oracle_s = walk(lambda w, c: vp.world_step(env, w, c),
                               lambda w, c: native.batched_vss_oracle(w, c, f, env.physics_cfg, env.time_step),
                               world, commands, f"native_oracle_vss_physics_{cname}")
        launches = check_launches(f"native_oracle_vss_physics_{cname}", wrappers, vp.vss_physics,
                                  vp.routed_entry(env, ORACLE_B), ORACLE_STEPS)
        phase(f"native_oracle_vss_physics_{cname}", card=card, B=ORACLE_B, steps=ORACLE_STEPS,
              route=vp.route(env, ORACLE_B), launches=launches, worst=worst, atol=native.ORACLE_ATOL,
              wheel_atol=native.ORACLE_WHEEL_ATOL, oracle_s=oracle_s)
    env = rt.make("SSLStaticDefenders-v0")
    world, commands = oracle_ssl_worlds(env.field, env.n_robots, ORACLE_SSL_B, gen, device)
    step = make_ssl_step(env.field, env.physics_cfg, env.time_step)
    worst, oracle_s = walk(step, lambda w, c: native.batched_ssl_oracle(w, c, env.field, env.physics_cfg,
                                                                         env.time_step),
                           world, commands, "native_oracle_ssl_plain")
    phase("native_oracle_ssl_plain", card=card, env="SSLStaticDefenders-v0", n_robots=env.n_robots,
          B=ORACLE_SSL_B, steps=ORACLE_STEPS, worst=worst, atol=native.ORACLE_ATOL,
          wheel_atol=native.ORACLE_WHEEL_ATOL, oracle_s=oracle_s)


def ssl_source(entry: str) -> str:
    """The source of the kernel that SD's or DR's route runs at B: the group
    kernels' ssl_full.cu or the one-thread kernels' ssl_thread.cu."""
    from rsoccer_tpu_torch.ops import ssl_full as sf

    return "rsoccer_tpu_torch/csrc/" + ("ssl_full.cu" if sf.route(entry, B) == "group" else "ssl_thread.cu")


def make_tasks():
    """The kernels' tasks: each fused env step, the physics kernel and the
    configurations beyond 3v3, with what main() checks, drives and times
    for each."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp

    def random_actions(n):
        return lambda obs, gen: torch.rand((n, obs.shape[-1]), generator=gen, device=obs.device) * 2 - 1

    def fused_benv(env):
        return BatchedEnv(env, B, device="cuda", fused=True, fused_rng="kernel")

    fused = dict(make_benv=fused_benv, calls=fused_calls, prepare=None, events=None,
                 need_events=())
    k1_ops, k1_ops_5v5, k1_ops_1v0 = vss_full_ops(6), vss_full_ops(10), vss_full_ops(1)
    tasks = [
        SimpleNamespace(
            name="vss_full_step", env_id="VSS-v0", wrapper=vf.vss_full_step,
            plain=vf.vss_full_step_plain, draw=vf.draw_step_rows,
            actions=random_actions(2), warm_steps=0, kernel_match=r"vss_(full|thread)_kernel",
            source="rsoccer_tpu_torch/csrc/vss_full.cu",
            replaces="rsoccer_tpu/ops/pallas_vss_full.py:142",
            entry="vss_full_step", ops_env=k1_ops[0], ops_reset=k1_ops[1],
            **fused,
        ),
        SimpleNamespace(
            name="ssl_sd_full_step", env_id="SSLStaticDefenders-v0", wrapper=sf.sd_full_step,
            plain=sf.sd_full_step_plain, draw=sf.sd_draw_step_rows,
            actions=chase_actions, warm_steps=WARM_STEPS, kernel_match=r"sd_(full|thread)_kernel",
            entry="ssl_sd_full_step", source=ssl_source("ssl_sd_full_step"),
            replaces="rsoccer_tpu/ops/pallas_ssl_full.py:456",
            ops_env=SD_OPS[0], ops_reset=SD_OPS[1],
            **fused,
        ),
        SimpleNamespace(
            name="ssl_cp_full_step", env_id="SSLContestedPossession-v0", wrapper=sf.cp_full_step,
            plain=sf.cp_full_step_plain, draw=sf.cp_draw_step_rows,
            actions=chase_actions, warm_steps=WARM_STEPS, kernel_match="cp_full_kernel",
            entry="ssl_cp_full_step",
            source="rsoccer_tpu_torch/csrc/ssl_full.cu",
            replaces="rsoccer_tpu/ops/pallas_ssl_full.py:824",
            ops_env=CP_OPS[0], ops_reset=CP_OPS[1],
            **fused,
        ),
        SimpleNamespace(
            name="ssl_dr_full_step", env_id="SSLDribbling-v0", wrapper=sf.dr_full_step,
            plain=sf.dr_full_step_plain, draw=sf.dr_draw_step_rows,
            actions=dribble_actions, warm_steps=WARM_STEPS, kernel_match=r"dr_(full|thread)_kernel",
            entry="ssl_dr_full_step", source=ssl_source("ssl_dr_full_step"),
            replaces="rsoccer_tpu/ops/pallas_ssl_full.py:1086",
            ops_env=DR_OPS[0], ops_reset=DR_OPS[1],
            make_benv=fused_benv, calls=fused_calls, prepare=dr_gate_states, events=dr_events,
            need_events=("crossings", "completions", "built_reverse_even"),
        ),
        SimpleNamespace(
            name="ssl_pe_full_step", env_id="SSLPassEndurance-v0", wrapper=sf.pe_full_step,
            plain=sf.pe_full_step_plain, draw=sf.pe_draw_step_rows,
            actions=pass_actions, warm_steps=WARM_STEPS, kernel_match="pe_full_kernel",
            entry="ssl_pe_full_step",
            source="rsoccer_tpu_torch/csrc/ssl_full.cu",
            replaces="rsoccer_tpu/ops/pallas_ssl_full.py:1327",
            ops_env=PE_OPS[0], ops_reset=PE_OPS[1],
            make_benv=fused_benv, calls=fused_calls, prepare=pe_pass_states, events=pe_events,
            need_events=("received", "built_stopped_wrong", "built_out_wrong"),
        ),
        SimpleNamespace(
            name="vss_physics", env_id="VSS-v0", wrapper=vp.vss_physics,
            kernel_match=r"vss_physics_(thread_)?kernel", source="rsoccer_tpu_torch/csrc/vss_physics.cu",
            replaces="rsoccer_tpu/ops/pallas_vss.py:37", entry="vss_physics_step",
            ops_env=vss_physics_ops(6), ops_reset=0,
            make_benv=lambda env: BatchedEnv(env, B, device="cuda", fused_physics=True),
            calls=physics_calls, **PHYSICS_DEPTH,
        ),
        # VSS's 5v5 division on its own field, through make_vec: the
        # 16-lane group kernels (the C entry their route names)
        SimpleNamespace(
            name="vss_5v5", kernel="vss_full_kernel (5v5, 16 lanes)", env_id="VSS-v0",
            env_kwargs=VSS_CONFIGS["5v5"], wrapper=vf.vss_full_step, plain=vf.vss_full_step_plain,
            draw=vf.draw_step_rows, actions=random_actions(2), warm_steps=0, kernel_match="vss_full_kernel",
            source="rsoccer_tpu_torch/csrc/vss_full.cu", replaces="rsoccer_tpu/ops/pallas_vss_full.py:142",
            entry="vss_full_step", ops_env=k1_ops_5v5[0], ops_reset=k1_ops_5v5[1],
            make_benv=lambda env: rt.make_vec("VSS-v0", B, device="cuda", fused=True, fused_rng="kernel",
                                              **VSS_CONFIGS["5v5"]),
            calls=fused_calls, prepare=None, events=None, need_events=(),
        ),
        # 1v0, which has no group kernel: the one-thread kernels
        SimpleNamespace(
            name="vss_1v0", kernel="vss_thread_kernel", env_id="VSS-v0", env_kwargs=VSS_CONFIGS["1v0"],
            wrapper=vf.vss_full_step, plain=vf.vss_full_step_plain, draw=vf.draw_step_rows,
            actions=random_actions(2), warm_steps=0, kernel_match="vss_thread_kernel",
            source="rsoccer_tpu_torch/csrc/vss_thread.cu", replaces="rsoccer_tpu/ops/pallas_vss_full.py:142",
            entry="vss_full_step_one_thread", ops_env=k1_ops_1v0[0], ops_reset=k1_ops_1v0[1],
            make_benv=lambda env: rt.make_vec("VSS-v0", B, device="cuda", fused=True, fused_rng="kernel",
                                              **VSS_CONFIGS["1v0"]),
            calls=fused_calls, prepare=None, events=None, need_events=(),
        ),
        # VSSMultiAgent-v0: three policy blues, K2 its one kernel path
        SimpleNamespace(
            name="vss_multiagent", kernel="vss_physics_kernel (VSSMultiAgent-v0)", env_id="VSSMultiAgent-v0",
            wrapper=vp.vss_physics, kernel_match=r"vss_physics_kernel",
            source="rsoccer_tpu_torch/csrc/vss_physics.cu", replaces="rsoccer_tpu/ops/pallas_vss.py:37",
            entry="vss_physics_step", ops_env=vss_physics_ops(6), ops_reset=0,
            make_benv=lambda env: BatchedEnv(env, B, device="cuda", fused_physics=True),
            calls=physics_calls, **PHYSICS_DEPTH,
        ),
        SimpleNamespace(
            name="vss_5v5_fused_physics", kernel="vss_physics_kernel (N = 10, 16 lanes)", env_id="VSS-v0",
            env_kwargs=VSS_CONFIGS["5v5"], wrapper=vp.vss_physics, kernel_match="vss_physics_kernel",
            source="rsoccer_tpu_torch/csrc/vss_physics.cu", replaces="rsoccer_tpu/ops/pallas_vss.py:37",
            entry="vss_physics_step", ops_env=vss_physics_ops(10), ops_reset=0,
            make_benv=lambda env: rt.make_vec("VSS-v0", B, device="cuda", fused_physics=True,
                                              **VSS_CONFIGS["5v5"]),
            calls=physics_calls, **PHYSICS_DEPTH,
        ),
        SimpleNamespace(
            name="vss_1v0_fused_physics", kernel="vss_physics_thread_kernel", env_id="VSS-v0",
            env_kwargs=VSS_CONFIGS["1v0"], wrapper=vp.vss_physics, kernel_match="vss_physics_thread_kernel",
            source="rsoccer_tpu_torch/csrc/vss_physics.cu", replaces="rsoccer_tpu/ops/pallas_vss.py:37",
            entry="vss_physics_step_one_thread", ops_env=vss_physics_ops(1), ops_reset=0,
            make_benv=lambda env: rt.make_vec("VSS-v0", B, device="cuda", fused_physics=True,
                                              **VSS_CONFIGS["1v0"]),
            calls=physics_calls, **PHYSICS_DEPTH,
        ),
    ]
    depth = dict(warm_rollouts=2, timed_rollouts=TIMED_ROLLOUTS, profile_steps=PROFILE_ROLLOUT_STEPS)
    for t in tasks:  # the SSL tasks: the reference configuration
        for k, v in (("kernel", t.name), ("env_kwargs", {}), ("entry", None), *depth.items()):
            if not hasattr(t, k):
                setattr(t, k, v)
    return tasks


def main() -> int:
    baseline = None
    if sys.argv[1:2] == ["--baseline"] and len(sys.argv) == 3:
        baseline = sys.argv[2]
    elif sys.argv[1:2] == ["--parallel-worker"] and len(sys.argv) == 6 and torch.cuda.is_available():
        return parallel_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif len(sys.argv) > 1:
        print("usage: chip_smoke.py [--baseline DIR]", file=sys.stderr)
        return 2
    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    # the port is imported before anything is printed: without the repo
    # beside this script the run fails here and prints no result
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.ops import _build
    from rsoccer_tpu_torch.ops import ssl_full as sf
    from rsoccer_tpu_torch.ops import vss_full as vf
    from rsoccer_tpu_torch.ops import vss_physics as vp

    if ONE_THREAD_B <= max(sf.GROUP_MAX_ENVS.values()):
        raise AssertionError(f"ONE_THREAD_B {ONE_THREAD_B} must exceed GROUP_MAX_ENVS {sf.GROUP_MAX_ENVS}")
    if not B <= min(*vf.GROUP_MAX_ENVS.values(), *vp.GROUP_MAX_ENVS.values()):
        raise AssertionError("the VSS main paths at 3v3 and 5v5 must run the group kernels")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", nvidia_smi=card, torch_name=kind,
          torch=torch.__version__, cuda=torch.version.cuda)
    os.makedirs(OUT_DIR, exist_ok=True)

    tasks = make_tasks()
    # checked by configuration below
    new_vss = ("vss_5v5", "vss_1v0", "vss_5v5_fused_physics", "vss_1v0_fused_physics", "vss_multiagent")

    # ---- 2. build: one nvcc per source, all at once, then one link
    t0 = time.perf_counter()
    lib_path, log, nvcc_s = _build.build()
    vf._library()
    sf._library()
    vp._library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as fh:
        fh.write(log)
    phase("build", nvcc_seconds=nvcc_s, total_seconds=time.perf_counter() - t0,
          library=str(lib_path.name), ptxas=ptxas)
    ssl_tasks = [t for t in tasks if t.name in SSL_ENTRIES]
    if baseline is not None:
        lib, base_ptxas = build_baseline(baseline)
        phase("baseline_build", source=baseline, ptxas=base_ptxas)
        vss_against_baseline(lib, card)
        if hasattr(lib, "vss_full_step_one_thread"):  # a tree with the one-thread VSS kernels
            vss_5v5_against_baseline(lib, card)
        ssl_against_baseline(lib, ssl_tasks, card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    # ---- 3. each kernel vs its plain version, both RNG modes
    errs = {}
    for task in tasks:
        if task.name in new_vss:
            continue
        if task.name == "vss_physics":
            errs[task.name], dones = check_physics_vs_plain()
            phase(f"kernel_vs_plain_{task.name}", B=B, steps=N_CHECK_STEPS,
                  max_abs_err=errs[task.name], atol=ATOL, dones=dones)
            continue
        err_in, at_in, dones_in, ev_in = check_kernel_vs_plain(task, "input")
        phase(f"kernel_vs_plain_input_{task.name}", B=B, steps=N_CHECK_STEPS,
              max_abs_err=err_in, worst_at=at_in, atol=ATOL, dones=dones_in,
              **({"events": ev_in} if ev_in else {}))
        err_k, at_k, dones_k, ev_k = check_kernel_vs_plain(task, "kernel")
        extra = {"philox_words_equal": check_philox_words()} if task is tasks[0] else {}
        if ev_k:
            extra["events"] = ev_k
        phase(f"kernel_vs_plain_kernel_rng_{task.name}", B=B, steps=N_CHECK_STEPS,
              max_abs_err=err_k, worst_at=at_k, atol=ATOL, dones=dones_k, **extra)
        errs[task.name] = max(err_in, err_k)

    # ---- 3a. K1, K4-K7 on a shard (env_base B/2): against their plain
    # versions, and bit for bit against the unsharded batch's columns
    for name, err in env_base_kernels(card, tasks).items():
        errs[name] = max(errs[name], err)

    # ---- 3b. the VSS kernels at a ragged batch
    for rng_mode in ("input", "kernel"):
        err, at, dones, _ = check_kernel_vs_plain(tasks[0], rng_mode, RAGGED_B)
        phase(f"kernel_vs_plain_ragged_{rng_mode}_vss_full_step", B=RAGGED_B, steps=N_CHECK_STEPS,
              max_abs_err=err, worst_at=at, atol=ATOL, dones=dones)
        errs["vss_full_step"] = max(errs["vss_full_step"], err)
    err, dones = check_physics_vs_plain(RAGGED_B)
    phase("kernel_vs_plain_ragged_vss_physics", B=RAGGED_B, steps=N_CHECK_STEPS, max_abs_err=err,
          atol=ATOL, dones=dones)
    errs["vss_physics"] = max(errs["vss_physics"], err)
    # K4-K7 through their routes at the ragged batch; K4 and K6 also past
    # their crossover, where they launch their one-thread kernels, and, where
    # B runs the one-thread kernel (DR), at a ragged batch of the group route
    for task in ssl_tasks:
        batches = ((RAGGED_B, "ragged"),)
        if task.name in sf.GROUP_ENTRIES:
            batches += ((ONE_THREAD_B, "one_thread"),)
            if sf.route(task.entry, B) == "thread":
                batches += ((sf.GROUP_MAX_ENVS[task.entry] - 1, "group"),)
        for batch, tag in batches:
            for rng_mode in ("input", "kernel"):
                err, at, dones, _ = check_kernel_vs_plain(task, rng_mode, batch)
                phase(f"kernel_vs_plain_{tag}_{rng_mode}_{task.name}", B=batch, route=sf.route(task.entry, batch),
                      steps=N_CHECK_STEPS, max_abs_err=err, worst_at=at, atol=ATOL, dones=dones)
                errs[task.name] = max(errs[task.name], err)

    # ---- 3c. VSS-v0 at the other team sizes and beyond the Taylor bound,
    # each error charged to the kernel that ran (the route): the 3v3 and
    # 5v5 group kernels, the one-thread kernels (1v0; 5v5 above its
    # crossover)
    k1, k2 = tasks[0], next(t for t in tasks if t.name == "vss_physics")
    errs.update({n: 0.0 for n in new_vss})
    for cname, kwargs in VSS_CONFIGS.items():
        task = SimpleNamespace(**{**vars(k1), "env_kwargs": kwargs})
        env = make_env(task)
        above = (vf.VSS_5V5_GROUP_MAX_ENVS + 1,) if cname == "5v5" else ()  # the one-thread kernel
        for batch in (B, RAGGED_B, *above):
            route = vf.route(env, batch)
            for rng_mode in ("input", "kernel"):
                err, at, dones, _ = check_kernel_vs_plain(task, rng_mode, batch)
                phase(f"kernel_vs_plain_{cname}_{rng_mode}_vss_full_step", B=batch, route=route,
                      entry=vf.routed_entry(env, batch), steps=N_CHECK_STEPS, max_abs_err=err, worst_at=at,
                      atol=ATOL, dones=dones)
                name = "vss_1v0" if route == "thread" else "vss_5v5" if cname == "5v5" else "vss_full_step"
                errs[name] = max(errs[name], err)
    for cname in ("5v5", "1v0"):
        env = rt.make("VSS-v0", **VSS_CONFIGS[cname])
        for batch in (B, RAGGED_B):
            err, dones = check_physics_vs_plain(batch, VSS_CONFIGS[cname])
            phase(f"kernel_vs_plain_{cname}_vss_physics", B=batch, route=vp.route(env, batch),
                  entry=vp.routed_entry(env, batch), steps=N_CHECK_STEPS, max_abs_err=err, atol=ATOL, dones=dones)
            name = "vss_5v5_fused_physics" if vp.route(env, batch) == "group" else "vss_1v0_fused_physics"
            errs[name] = max(errs[name], err)
    phase("thread_vs_group_bit_equal", B=VSS_THREAD_B, comparisons=check_thread_vs_group())
    # the physics kernel under multi-agent and self-play actions (policy-like,
    # every robot's wheels), through auto-resets
    for env_id, tag in ((MA_ID, "multiagent"), (SP_ID, "selfplay")):
        env = rt.make(env_id)
        for batch in (B, RAGGED_B):
            err, dones = check_physics_vs_plain(batch, env_id=env_id,
                                                actions=policy_like_actions(env.action_size, env.obs_size))
            phase(f"kernel_vs_plain_{tag}_vss_physics", env=env_id, B=batch, route=vp.route(env, batch),
                  steps=N_CHECK_STEPS, max_abs_err=err, atol=ATOL, dones=dones)
            errs["vss_multiagent"] = max(errs["vss_multiagent"], err)

    # ---- 3d. the VSS kernels and K4-K7 at larger batches, timed
    time_at_scale(card, k1, k2, ssl_tasks)

    # ---- 4. each main path, through its kernel, timed
    kernels = []
    epi_launches, epi_err = 0, 0.0
    for task in tasks:
        rec, epi = main_path(task, tasks, card)
        rec["max_abs_err"] = errs[task.name]
        kernels.append(rec)
        epi_launches += epi["launches"]
        epi_err = max(epi_err, epi["max_abs_err"])
        if task.name in ("ssl_cp_full_step", "ssl_pe_full_step"):
            phase(f"done_share_{task.name}", card=card, B=B, **done_shares(task))
    kernels.append(epilogue_record(card, epi_launches, epi_err))

    # ---- 5. PPO: train on the main path, resume, score the shipped policies
    wrappers = list({id(t.wrapper): t.wrapper for t in tasks}.values())
    trainer, state, train_out = ppo_train(card, wrappers)
    trainer, state = ppo_resume(trainer, state)
    rec, err = ppo_profile(card, trainer, state, k1, train_out)
    rec["max_abs_err"] = max(err, errs["vss_full_step"])  # and both obs variants, section 3
    kernels.append(rec)
    ppo_checkpoint(card, wrappers)
    ppo_ssl_checkpoints(card, wrappers, ssl_tasks)

    # ---- 6. SAC: train on StaticDefenders, resume, profile, score the shipped actors
    k4 = next(t for t in tasks if t.name == "ssl_sd_full_step")
    sac_trainer, sac_state, sac_out = sac_train(card, wrappers)
    sac_trainer, sac_state = sac_resume(sac_trainer, sac_state)
    rec, err = sac_profile(card, sac_trainer, sac_state, k4, sac_out)
    rec["max_abs_err"] = max(err, errs["ssl_sd_full_step"])  # and both obs variants, section 3
    kernels.append(rec)
    sac_checkpoint(card, wrappers, ssl_tasks)

    # ---- 7. the scripted experts and BC: K4, K6, K7 under state policies
    expert_score(card, wrappers, ssl_tasks)
    bc_train(card, wrappers, ssl_tasks)
    bc_checkpoints(card, wrappers, ssl_tasks)

    # ---- 8. multi-agent and self-play: train the league recipe, resume, score the league
    sp_trainer, sp_state, rec = selfplay_train(card, wrappers, k2, errs["vss_multiagent"])
    kernels.append(rec)
    selfplay_resume(sp_trainer, sp_state)
    kernels.append(selfplay_checkpoint(card, wrappers, k2, errs["vss_multiagent"]))

    # ---- 9. the gymnasium wrappers' numpy core: K1, K4-K7 under HostVectorEnv,
    # the single env, the host views, the custom env
    gym_envs = {t.name: gym_vector(card, wrappers, t) for t in tasks if t.name in GYM_TASKS}
    gym_single_vss(card, wrappers)
    host_views(card, {k: gym_envs[k] for k in ("vss_full_step", "ssl_sd_full_step")})
    custom_env(card, wrappers)

    # ---- 10. data parallelism: the sharded rollout, PPO and SAC at two
    # ranks on this card (gloo) and one (nccl); crash and resume
    t_par = time.perf_counter()
    parallel_phases(card, wrappers, k4)
    elastic_resume(card, wrappers)
    phase("parallel_total", card=card, seconds=time.perf_counter() - t_par)

    # ---- 11. the tools: bench_all, the profilers, the rooflines, the SD spawn slice
    t_tools = time.perf_counter()
    tool_bench_all(card, wrappers, tasks)
    tool_profiles(card, wrappers, k1, k4)
    tool_rooflines(card, wrappers)
    tool_sd_spawn_slice(card, wrappers)
    phase("tools_total", card=card, seconds=time.perf_counter() - t_tools)

    # ---- 12. the physics calibration: the self-test, a fit at a log's size
    t_cal = time.perf_counter()
    calibrate_selftest(card)
    calibrate_timed_fit(card)
    # ---- 13. the C++ oracles: K2 at 3v3 and 5v5, the plain SSL physics
    native_oracle(card, wrappers)
    phase("calibrate_oracle_total", card=card, seconds=time.perf_counter() - t_cal)
    phase("total", card=card, seconds=time.perf_counter() - _T0)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
