"""Fused VSS-v0 step: the whole env step as ONE CUDA kernel launch.

Replaces the TPU kernel ``rsoccer_tpu/ops/pallas_vss_full.py:142``
(``make_pallas_vss_full_step``), at every team size it runs: from 1v0 to
5v5, in and beyond the Taylor bound of its heading rotation.  The kernels
are in ``csrc/vss_full.cu`` (the group kernel) and ``csrc/vss_thread.cu``,
``vss_thread_capped.cu`` (the one-thread kernel; both on ``vss_step.cuh``,
the VSS substep of ``csrc/vss_world.cuh`` and ``csrc/philox.cuh``): OU
update -> wheel commands with the deadzone ->
5 physics substeps -> reward/termination -> on done envs only, spawn
placement -> auto-reset select -> obs.  :func:`route` picks one of two
designs per launch:

- ``"group"`` (``vss_full_kernel``, 3v3 and 5v5): one env on a group of
  lanes, one robot per lane: 8 lanes at 3v3, 16 at 5v5.  At 8192 envs a
  step moves 5.8 MB (3v3) or 8.7 MB (5v5), 2-3 us of HBM time, while the
  env's work is a dependent scalar chain; the lanes split that chain by
  robot and by pair and put 2048 (3v3) or 4096 (5v5) warps on 132 SMs;
  each block stages its 32 (3v3) or 16 (5v5) envs' rows through shared
  memory.
- ``"thread"`` (``vss_thread_kernel``, every team size): one env per
  thread, what the substeps read in registers.  Above the team size's
  entry of ``GROUP_MAX_ENVS`` the card is full and the group's replicated
  ball work costs more than its lanes save, so 3v3 and 5v5 run here too;
  every other team size always does.  For 7-10 robots above
  ``THREAD_UNCAPPED_MAX_ENVS`` envs the C entry launches the same step with
  its registers capped (128, 16 warps per SM: :func:`routed_entry`).

The crossovers, measured in turns on the card (on the redesigned
one-thread kernel, both RNG modes): at 3v3 the group kernel wins at 16384
envs (25.46 against 26.83 us with kernel RNG) and loses from 24576 (37.49
against 30.81); at 5v5 it wins at 16384 (46.86 against 53.80) and loses
from 24576 (68.73 against 60.61); at 5v5 the uncapped one-thread kernel
wins up to 32768 envs (70.46 against 88.60 capped) and the capped one from
49152 on, also against the group kernel (118.49 against 171.91 at 65536,
248.51 against 328.57 at 131072).

Both give the same bits at 3v3 and 5v5.  ``rng="kernel"`` draws the
random words in registers, the reset's only on done envs.  The state
stays in the packed ``(S, B)`` layout across a whole rollout, so there is
no per-step pack/unpack.

State row layout (N = n_robots), identical to the TPU kernel's:
    0:6         ball x, y, z, v_x, v_y, v_z
    6+0N:6+6N   robot x, y, theta, v_x, v_y, v_theta (N rows each)
    6+6N        steps (f32; exact integers)
    7+6N:7+8N   OU state, wheel-major: N wheel-0 rows then N wheel-1 rows
    7+8N        ball_potential
    8+8N        has_potential (0/1)
    9+8N:15+8N  shaping accumulators (envs/vss._SHAPING_KEYS order)
Aux rows: [reward, terminated, truncated, shaping0..5] — the shaping rows
are the PRE-reset accumulators (the step's info); the state holds the
post-reset values.

RNG — a deliberate departure from the TPU.  There, ``rng="input"`` and
``rng="kernel"`` were different streams (a host generator vs the TPU's
hardware PRNG).  Here both are the one Philox stream of ``ops/philox.py``:
``rng="kernel"`` draws the words in the kernel from the device key tensor
``[k0, k1, step]``; the plain path draws the same words with
``envs/base.draw_noise``.  Both count envs from ``env_base`` (the global
index of column 0, an argument of the C entries): a shard of a larger
batch (``parallel/``) draws that batch's columns.  So the kernel-RNG variant is testable against
its plain version and, through the input rows, against the JAX kernel.

:func:`vss_full_step` runs the plain version :func:`vss_full_step_plain`
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  Each launch counts in ``utils/tracing``'s table under
``vss_full_step``, by C entry (``vss_full_step``: the group kernels,
``vss_full_step_one_thread``: the one-thread kernel,
``vss_full_step_one_thread_capped``: its capped variant) and by whether
the ``emit_final`` variant ran.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from rsoccer_tpu_torch.core.state import BallState, RobotsState, WorldState
from rsoccer_tpu_torch.envs import spawn as spawn_mod
from rsoccer_tpu_torch.envs.base import draw_noise, step_noise_spec
from rsoccer_tpu_torch.envs.ou import OU_THETA
from rsoccer_tpu_torch.envs.vss import _SHAPING_KEYS, VSSEnv, VSSState
from rsoccer_tpu_torch.ops import _build
from rsoccer_tpu_torch.physics.vss import HALF_AXLE, achieved_wheel_speeds
from rsoccer_tpu_torch.utils import tracing

N_AUX = 3 + len(_SHAPING_KEYS)
N_BLUE = range(1, 6)  # team sizes the kernels run: 1v0 to 5v5
N_YELLOW = range(0, 6)
N_SUBSTEPS = 5  # compiled into the kernels
# Up to this many envs 3v3 launches the 8-lane group kernel, above it the
# one-thread kernel: measured in turns on the card, the group kernel wins
# at 16384 envs and loses from 24576 on, in both RNG modes (PERF.md,
# section 6).
VSS_GROUP_MAX_ENVS = 16384
# Up to this many envs 5v5 launches the 16-lane group kernel, above it the
# one-thread kernel (its capped variant from 49152): measured in turns on
# the card, the group kernel wins at 16384 envs and loses from 24576 on,
# in both RNG modes (PERF.md, section 6).
VSS_5V5_GROUP_MAX_ENVS = 16384
# (blue, yellow) -> the batch up to which that team size launches its group
# kernel; the team sizes not listed have only the one-thread kernel
GROUP_MAX_ENVS = {(3, 3): VSS_GROUP_MAX_ENVS, (5, 5): VSS_5V5_GROUP_MAX_ENVS}
# Robot counts whose one-thread kernel has a register-capped variant (128
# registers, 16 warps per SM), and the batch up to which they launch the
# uncapped one: above it the uncapped kernel (168-255 registers, 8-12
# warps) needs more than one wave of the card and the capped one runs
# faster; up to it the capped one's spills cost more than its warps gain
# (measured in turns on the card at 5v5: 70.46 against 88.60 us at 32768
# envs, 176.63 against 118.49 at 65536; PERF.md, section 6).
THREAD_CAPPED_ROBOTS = range(7, 11)
THREAD_UNCAPPED_MAX_ENVS = 32768
THREAD_BLOCK = 64  # the one-thread kernels' block (csrc kThreadBlock)
THREAD_CAPPED_MIN_BLOCKS = 8  # the capped variant's launch bounds (csrc kCappedMinBlocks)


def state_size(n_robots: int) -> int:
    return 15 + 8 * n_robots


def pack_vss_state(state: VSSState) -> torch.Tensor:
    """Batched VSSState (batch-last) -> (S, B) f32."""
    w = state.world
    b = w.ball
    rows = [
        torch.stack([b.x, b.y, b.z, b.v_x, b.v_y, b.v_z]),
        w.robots.x, w.robots.y, w.robots.theta,
        w.robots.v_x, w.robots.v_y, w.robots.v_theta,
        state.steps[None].to(torch.float32),
        state.ou_x[:, 0], state.ou_x[:, 1],  # (N, 2, B) -> wheel-major
        state.ball_potential[None],
        state.has_potential[None].to(torch.float32),
        state.shaping,
    ]
    return torch.cat(rows, dim=0)


def unpack_vss_state(arr: torch.Tensor, n_robots: int, wheel_radius: float) -> VSSState:
    """(S, B) -> batched VSSState; ``v_wheel`` is recomputed from the body
    state with physics/vss's epilogue formula."""
    n = n_robots
    x, y, theta, vx, vy, vth = arr[6 : 6 + 6 * n].reshape(6, n, -1)
    o = 6 + 6 * n
    steps = arr[o].to(torch.int32)
    ou = torch.stack([arr[o + 1 : o + 1 + n], arr[o + 1 + n : o + 1 + 2 * n]], dim=1)
    o += 1 + 2 * n
    world = WorldState(
        ball=BallState(*arr[0:6]),
        robots=RobotsState(
            x=x, y=y, theta=theta, v_x=vx, v_y=vy, v_theta=vth,
            infrared=torch.zeros_like(x, dtype=torch.bool),
            v_wheel=achieved_wheel_speeds(vx, vy, theta, vth, wheel_radius),
        ),
    )
    return VSSState(
        world=world, steps=steps, ou_x=ou,
        ball_potential=arr[o], has_potential=arr[o + 1] > 0.5,
        shaping=arr[o + 2 : o + 2 + len(_SHAPING_KEYS)],
    )


def noise_rows(env: VSSEnv, t_noise: dict, r_noise: dict):
    """Noise dicts -> the kernel's input rows (ou (2N,B) wheel-major,
    spawn ((1+N)*2*K, B), theta (N, B))."""
    ou = t_noise["ou"]
    b = ou.shape[-1]
    return (
        torch.cat([ou[:, 0], ou[:, 1]], dim=0),
        r_noise["spawn"].reshape(-1, b),
        r_noise["theta"].reshape(env.n_robots, b),
    )


def draw_step_rows(env: VSSEnv, key: torch.Tensor, batch: int, env_base: int = 0):
    """The step's noise rows from ``key``'s Philox stream for the envs from
    global index ``env_base`` on; advances key."""
    noise = draw_noise(key, step_noise_spec(env), batch, env_base)
    return noise_rows(env, noise, noise)


def vss_full_step_plain(env: VSSEnv, state, action, ou_noise, spawn_u, theta_u,
                        emit_final: bool = False):
    """Plain PyTorch version of the fused step: the port's own env
    functions over the packed state (unpack -> pre_physics -> physics ->
    post_physics -> reset select -> observe -> pack).

    Returns ``(state (S,B), obs (O or 2*O, B), aux (9, B))``.
    """
    n = env.n_robots
    b = state.shape[-1]
    s = unpack_vss_state(state, n, env.field.rbt_wheel_radius)
    t_noise = {"ou": torch.stack([ou_noise[:n], ou_noise[n:]], dim=1)}
    r_noise = {
        "spawn": spawn_u.reshape(1 + n, 2, spawn_mod.N_CANDIDATES, b),
        "theta": theta_u,
    }
    if emit_final:
        ns, obs, fobs, rew, term, trunc, info = env.step_with_noise_final(
            s, action, t_noise, r_noise
        )
        obs = torch.cat([obs, fobs])
    else:
        ns, obs, rew, term, trunc, info = env.step_with_noise(
            s, action, t_noise, r_noise
        )
    aux = torch.stack(
        [rew, term.to(rew.dtype), trunc.to(rew.dtype)]
        + [info[k] for k in _SHAPING_KEYS]
    )
    return pack_vss_state(ns), obs, aux


# ------------------------------------------------------------- the kernel
PARAM_FIELDS = (
    "dt dts lat_keep a_lin a_ang max_wheel wheel_r two_half_axle "
    "ou_theta ou_sig_sqdt max_v deadzone "
    "half_len half_wid goal_half hl_goal r_ball two_r r_sum xl yl "
    "ground_z fric gravity_dts neg_rest_ground bounce_min_v rbt_height "
    "pair_gain ball_gain neg_rest_wall "
    "half_l_pot length100 max_steps "
    "max_pos max_w_rad nbnd "
    "x_lo x_span y_lo y_span min_d2 two_pi pi"
).split()


class _Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in PARAM_FIELDS]


def kernel_params(env: VSSEnv) -> dict:
    """The kernel's constants, folded in double precision exactly where
    the TPU kernel folded Python floats, then rounded to f32 once."""
    f, cfg, dt = env.field, env.physics_cfg, env.time_step
    dts = dt / cfg.n_substeps
    max_wheel = f.max_wheel_rad_s
    return dict(
        dt=dt, dts=dts, lat_keep=math.exp(-cfg.lateral_decay * dts),
        a_lin=cfg.robot_accel * dts, a_ang=cfg.robot_alpha * dts,
        max_wheel=max_wheel, wheel_r=f.rbt_wheel_radius,
        two_half_axle=2.0 * HALF_AXLE,
        ou_theta=OU_THETA, ou_sig_sqdt=0.5 * math.sqrt(dt),
        max_v=env.max_v, deadzone=env.v_wheel_deadzone,
        half_len=f.half_length, half_wid=f.half_width,
        goal_half=f.goal_width / 2, hl_goal=f.half_length + f.goal_depth,
        r_ball=f.ball_radius, two_r=2.0 * f.rbt_radius,
        r_sum=f.rbt_radius + f.ball_radius,
        xl=f.half_length - f.rbt_radius, yl=f.half_width - f.rbt_radius,
        ground_z=f.ball_radius + 1e-4, fric=cfg.ball_friction_decel * dts,
        gravity_dts=cfg.gravity * dts, neg_rest_ground=-cfg.rest_ball_ground,
        bounce_min_v=cfg.ball_bounce_min_v, rbt_height=cfg.rbt_height,
        pair_gain=-(1.0 + cfg.rest_robot_robot) * 0.5,
        ball_gain=-(1.0 + cfg.rest_ball_robot),
        neg_rest_wall=-cfg.rest_ball_wall,
        half_l_pot=f.half_length + f.goal_depth, length100=f.length * 100.0,
        max_steps=float(env.max_episode_steps),
        max_pos=env.max_pos, max_w_rad=env.max_w_rad, nbnd=env.norm_bounds,
        x_lo=-f.half_length + 0.1,
        x_span=(f.half_length - 0.1) - (-f.half_length + 0.1),
        y_lo=-f.half_width + 0.1,
        y_span=(f.half_width - 0.1) - (-f.half_width + 0.1),
        min_d2=0.1 * 0.1, two_pi=2.0 * math.pi, pi=math.pi,
    )


def taylor_rotation_holds(env: VSSEnv) -> bool:
    """Whether the kernels may rotate each heading by Taylor terms: they are
    exact in f32 while a substep turns by at most 0.35 rad, and |w| never
    exceeds the wheel-limited target, so a substep turns by at most
    w_max * dts.  Beyond it (``time_step`` > 0.0584 s on the VSS fields)
    they take exact ``cosf``/``sinf`` each substep, as the TPU kernel's
    fallback does."""
    f = env.field
    w_max = f.rbt_wheel_radius * f.max_wheel_rad_s / HALF_AXLE
    return w_max * env.time_step / env.physics_cfg.n_substeps <= 0.35


def route(env: VSSEnv, batch: int) -> str:
    """Which kernel a step of ``batch`` envs launches: ``"group"`` (3v3 on
    8 lanes per env up to ``VSS_GROUP_MAX_ENVS`` envs, 5v5 on 16 up to
    ``VSS_5V5_GROUP_MAX_ENVS``) or ``"thread"`` (one thread per env).
    Raises ``NotImplementedError`` outside the team sizes the kernels run."""
    nb, ny = env.n_blue, env.n_yellow
    if nb not in N_BLUE or ny not in N_YELLOW or env.physics_cfg.n_substeps != N_SUBSTEPS:
        raise NotImplementedError(
            f"the CUDA kernels run {N_BLUE.start}-{N_BLUE.stop - 1} blue and "
            f"{N_YELLOW.start}-{N_YELLOW.stop - 1} yellow robots with "
            f"{N_SUBSTEPS} substeps; got ({nb}, {ny}), "
            f"{env.physics_cfg.n_substeps} substeps"
        )
    return "group" if batch <= GROUP_MAX_ENVS.get((nb, ny), 0) else "thread"


def routed_entry(env: VSSEnv, batch: int) -> str:
    """The C entry that a step of ``batch`` envs launches (:func:`route`):
    ``vss_full_step`` (the group kernels), ``vss_full_step_one_thread``,
    or, for 7-10 robots above ``THREAD_UNCAPPED_MAX_ENVS`` envs,
    ``vss_full_step_one_thread_capped``."""
    if route(env, batch) == "group":
        return "vss_full_step"
    capped = env.n_robots in THREAD_CAPPED_ROBOTS and batch > THREAD_UNCAPPED_MAX_ENVS
    return "vss_full_step_one_thread_capped" if capped else "vss_full_step_one_thread"


_PARAMS_CACHE: dict = {}


def _params_struct(env: VSSEnv) -> _Params:
    """The ctypes struct for ``env``'s configuration (the C side only
    reads it), built once per configuration rather than per launch."""
    k = (env.field, env.physics_cfg, env.time_step, env.max_episode_steps,
         env.v_wheel_deadzone, env.norm_bounds)
    if k not in _PARAMS_CACHE:
        _PARAMS_CACHE[k] = _Params(**kernel_params(env))
    return _PARAMS_CACHE[k]


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load()
    fields = lib.vss_params_fields().decode().rstrip(",").split(",")
    if fields != PARAM_FIELDS:
        raise RuntimeError(
            f"csrc/vss_full.cu VssParams {fields} != PARAM_FIELDS {PARAM_FIELDS}"
        )
    return lib


def _launch(env, state, action, ou_noise, spawn_u, theta_u, key, emit_final, env_base):
    n, nb = env.n_robots, env.n_blue
    dev = state.device
    b = state.shape[-1]
    entry = routed_entry(env, b)
    _build.check_operand(state, "state", state_size(n), b, dev)
    _build.check_operand(action, "action", env.action_size, b, dev)
    rng_kernel = key is not None
    if rng_kernel:
        _build.check_key(key, dev)
        _build.check_env_base(env_base, b)
    else:
        _build.check_operand(ou_noise, "ou_noise", 2 * n, b, dev)
        _build.check_operand(spawn_u, "spawn_u", (1 + n) * 2 * spawn_mod.N_CANDIDATES, b, dev)
        _build.check_operand(theta_u, "theta_u", n, b, dev)

    lib = _library()
    params = _params_struct(env)
    obs_rows = env.obs_size * (2 if emit_final else 1)
    st_out = torch.empty_like(state)
    obs = torch.empty((obs_rows, b), dtype=torch.float32, device=dev)
    aux = torch.empty((N_AUX, b), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            nb, n - nb, int(emit_final), int(rng_kernel),
            int(not taylor_rotation_holds(env)), ctypes.byref(params),
            ptr(state), ptr(action), ptr(ou_noise), ptr(spawn_u), ptr(theta_u),
            ptr(key), st_out.data_ptr(), obs.data_ptr(), aux.data_ptr(), env_base, b,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    tracing.launched("vss_full_step", entry, emit_final)
    if rng_kernel:
        key[2:].add_(1)  # in-stream: the next step reads the next counter
    return st_out, obs, aux


def vss_full_step(env: VSSEnv, state, action, ou_noise=None, spawn_u=None,
                  theta_u=None, *, key=None, emit_final: bool = False, env_base: int = 0):
    """One fused VSS step.

    Noise either as input rows (``ou_noise``, ``spawn_u``, ``theta_u``), or
    drawn from ``key`` (int64 ``[k0, k1, step]``, advanced by one) — in the
    kernel on a CUDA device, by :func:`draw_step_rows` on the CPU — for the
    envs from global index ``env_base`` on (a shard of a larger batch).
    Returns ``(state, obs, aux)``.
    """
    if (key is None) == (ou_noise is None):
        raise ValueError("pass exactly one of: the noise rows, key")
    if state.device.type == "cuda":
        return _launch(env, state, action, ou_noise, spawn_u, theta_u, key,
                       emit_final, env_base)
    if state.device.type != "cpu":
        raise NotImplementedError(
            f"vss_full_step runs on CUDA (kernel) or CPU (plain version), "
            f"not {state.device.type}"
        )
    if key is not None:
        ou_noise, spawn_u, theta_u = draw_step_rows(env, key, state.shape[-1], env_base)
    return vss_full_step_plain(env, state, action, ou_noise, spawn_u, theta_u,
                               emit_final)
