"""Fused SSL steps: SSLStaticDefenders-v0, SSLContestedPossession-v0,
SSLDribbling-v0 and SSLPassEndurance-v0, each as ONE CUDA kernel launch.

Replaces the TPU kernels ``rsoccer_tpu/ops/pallas_ssl_full.py:456``
(``make_pallas_sd_full_step``), ``:824`` (``make_pallas_cp_full_step``),
``:1086`` (``make_pallas_dr_full_step``) and ``:1327``
(``make_pallas_pe_full_step``), with their shared launch ``_build_call``
(``:289``) and SSL world body ``make_ssl_physics_body`` (``:90``).  The
kernels are ``csrc/ssl_full.cu`` and, for SD's and DR's one-thread
kernels, ``csrc/ssl_thread.cu`` (on the shared ``csrc/ssl_task.cuh``):
action conversion -> 5 SSL substeps (omni drive, robot contacts, dribbler,
vertical ball, ball-robot with the dribbler face, kick, infrared) -> the
task's termination and reward -> on done envs only, the reset ->
auto-reset select -> obs.  :func:`route`
picks the design per launch, by batch: the StaticDefenders and Dribbling
steps run one env on a group of 8 lanes, one robot per lane, on the
cooperative world step ``csrc/ssl_world.cuh``, up to their
``GROUP_MAX_ENVS`` envs (``"group"``: SD 8448, DR 4096), and one env per
thread above it (``"thread"``); the
ContestedPossession and PassEndurance steps run one env per thread at
every batch.  The one-thread kernels step the world with
``csrc/ssl_body.cuh`` (and ``pair_collide.cuh``); ``philox.cuh`` serves
the in-kernel draws.  The one-thread SD kernel spreads a warp's resets
over its 32 lanes (8 per done env, up to 4 at once).

State row layout (N robots), identical to the TPU kernels':
    0:6          ball x, y, z, v_x, v_y, v_z
    6+0N:6+6N    robot x, y, theta, v_x, v_y, v_theta (N rows each)
    6+6N         steps (f32; exact integers)
    7+6N:        the task's rows: SD/CP the shaping accumulators (the env's
                 _SHAPING_KEYS order); DR the checkpoint count; PE the
                 stopped counter, then reversed_dist and ball_grad
Aux rows: [reward, terminated, truncated, info...] with the PRE-reset
values (the step's info; DR has none).  Infrared and the wheel speeds are
not stored; the ``unpack_*_state`` functions recompute them.

RNG, as ``ops/vss_full.py``: ``key=...`` draws the step's reset noise from
the port's one Philox stream — in the kernel on the card (only on done
lanes; the counter scheme has no state, so the words are the same), with
``envs/base.draw_noise`` on the CPU — at the slots of ``draw_noise``'s spec
order (SD: ball 0-15, yellow i's candidates 16+16i, theta 112-117; CP:
enemy 0-1; PE: ball 0-1, recv_x 2-17; DR draws nothing), for the global
env indices from ``env_base`` on (a shard of a larger batch, ``parallel/``;
an argument of the C entries that draw), and advances ``key[2]`` by one
(DR too, so every task keeps one key schedule).

The ``*_full_step`` wrappers run the plain versions ``*_full_step_plain``
only for tensors on the CPU; for CUDA tensors they launch the kernel or
raise.  Each counts its launches in ``utils/tracing``'s table under its
own name, by C entry (:func:`routed_entry`) and by whether the
``emit_final`` variant ran.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from rsoccer_tpu_torch.core.state import BallState, RobotsState, WorldState
from rsoccer_tpu_torch.envs import spawn as spawn_mod
from rsoccer_tpu_torch.envs.base import draw_noise, step_noise_spec
from rsoccer_tpu_torch.envs.ssl_contested_possession import (
    _SHAPING_KEYS as CP_KEYS, CPState, SSLContestedPossessionEnv,
)
from rsoccer_tpu_torch.envs.ssl_dribbling import DribblingState
from rsoccer_tpu_torch.envs.ssl_pass_endurance import (
    _SHAPING_KEYS as PE_KEYS, N_CAND, PEState, SSLPassEnduranceEnv,
)
from rsoccer_tpu_torch.envs.ssl_static_defenders import (
    _SHAPING_KEYS as SD_KEYS, SDState, SSLStaticDefendersEnv,
)
from rsoccer_tpu_torch.ops import _build
from rsoccer_tpu_torch.physics.config import SSL_PHYSICS
from rsoccer_tpu_torch.physics.ssl import (
    achieved_wheel_speeds, make_face_zone, wheel_jacobian,
)
from rsoccer_tpu_torch.utils import tracing

N_SUBSTEPS = 5  # compiled into the kernels
SD_ROBOTS, CP_ROBOTS, DR_ROBOTS, PE_ROBOTS = 7, 2, 5, 2  # compiled into the kernels
# Up to this many envs (by C entry) the SD and DR steps launch their 8-lane
# group kernels, above it their one-thread-per-env kernels: the crossovers
# the H100 measured in turns on the main path's state (PERF.md, section 6).
# SD's group kernel wins up to one wave of its 32-env blocks (two resident
# per SM on the 132 SMs) and loses from 10240 envs on; DR's wins at 4096
# envs (one block per SM) and loses from 6144 on, 8192 included.
GROUP_MAX_ENVS = {"ssl_sd_full_step": 8448, "ssl_dr_full_step": 4096}
THREAD_BLOCK = 128  # the one-thread SD and DR kernels' block (csrc/ssl_thread.cu: kThreadBlock)
# the fused steps' C entries; the first two also have a group kernel
GROUP_ENTRIES = ("ssl_sd_full_step", "ssl_dr_full_step")
ENTRIES = GROUP_ENTRIES + ("ssl_cp_full_step", "ssl_pe_full_step")
K = spawn_mod.N_CANDIDATES
DR_KEYS = ()  # the reference's Dribbling step has no info keys


def state_size(n_robots: int, n_extra: int) -> int:
    return 7 + 6 * n_robots + n_extra


def sd_state_size(n_robots: int = SD_ROBOTS) -> int:
    return state_size(n_robots, len(SD_KEYS))


def cp_state_size() -> int:
    return state_size(CP_ROBOTS, len(CP_KEYS))


def dr_state_size() -> int:
    return state_size(DR_ROBOTS, 1)  # 38: + the checkpoint count


def pe_state_size() -> int:
    return state_size(PE_ROBOTS, 1 + len(PE_KEYS))  # 22: + stopped_steps, shaping


def _pack(state, *extra) -> torch.Tensor:
    """Batched SSL task state (batch-last) -> (S, B) f32: ball, robots,
    steps, then the task's ``extra`` rows."""
    w = state.world
    b = w.ball
    return torch.cat([
        torch.stack([b.x, b.y, b.z, b.v_x, b.v_y, b.v_z]),
        w.robots.x, w.robots.y, w.robots.theta,
        w.robots.v_x, w.robots.v_y, w.robots.v_theta,
        state.steps[None].to(torch.float32),
        *extra,
    ])


def pack_ssl_state(state) -> torch.Tensor:
    """Batched SDState or CPState -> (S, B) f32."""
    return _pack(state, state.shaping)


pack_sd_state = pack_cp_state = pack_ssl_state


def pack_dr_state(state: DribblingState) -> torch.Tensor:
    return _pack(state, state.checkpoints[None].to(torch.float32))


def pack_pe_state(state: PEState) -> torch.Tensor:
    return _pack(state, state.stopped_steps[None].to(torch.float32), state.shaping)


def _unpack_world(arr: torch.Tensor, env):
    """(S, B) -> (world, steps int32, the task's extra rows).  Infrared
    comes from the kicker face predicate with ``SSL_PHYSICS`` and the wheel
    speeds from the forward jacobian, both of the packed state, as the JAX
    package's ``_unpack_world`` recomputes them."""
    n = env.n_robots
    f = env.field
    x, y, theta, vx, vy, vth = arr[6 : 6 + 6 * n].reshape(6, n, -1)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    infrared = make_face_zone(f, SSL_PHYSICS)(x, y, cos_t, sin_t, arr[0], arr[1], arr[2])
    world = WorldState(
        ball=BallState(*arr[0:6]),
        robots=RobotsState(
            x=x, y=y, theta=theta, v_x=vx, v_y=vy, v_theta=vth, infrared=infrared,
            v_wheel=achieved_wheel_speeds(vx, vy, cos_t, sin_t, vth,
                                          wheel_jacobian(f), f.rbt_wheel_radius),
        ),
    )
    o = 6 + 6 * n
    return world, arr[o].to(torch.int32), arr[o + 1:]


def unpack_sd_state(arr: torch.Tensor, env) -> SDState:
    world, steps, rest = _unpack_world(arr, env)
    return SDState(world=world, steps=steps, shaping=rest)


def unpack_cp_state(arr: torch.Tensor, env) -> CPState:
    world, steps, rest = _unpack_world(arr, env)
    return CPState(world=world, steps=steps, shaping=rest)


def unpack_dr_state(arr: torch.Tensor, env) -> DribblingState:
    world, steps, rest = _unpack_world(arr, env)
    return DribblingState(world=world, steps=steps, checkpoints=rest[0].to(torch.int32))


def unpack_pe_state(arr: torch.Tensor, env) -> PEState:
    world, steps, rest = _unpack_world(arr, env)
    return PEState(world=world, steps=steps, stopped_steps=rest[0].to(torch.int32),
                   shaping=rest[1:])


# ------------------------------------------------------------ noise rows
def sd_noise_rows(env, r_noise: dict):
    """Reset noise -> SD's input rows (ball_u (2K, B), spawn_u (6*2K, B),
    theta_u (6, B))."""
    b = r_noise["ball"].shape[-1]
    return (r_noise["ball"].reshape(-1, b), r_noise["spawn"].reshape(-1, b),
            r_noise["theta"].reshape(-1, b))


def cp_noise_rows(env, r_noise: dict):
    """Reset noise -> CP's input row block (enemy_u (2, B),)."""
    return (r_noise["enemy"].reshape(-1, r_noise["enemy"].shape[-1]),)


def sd_draw_step_rows(env, key: torch.Tensor, batch: int, env_base: int = 0):
    """The step's SD noise rows from ``key``'s Philox stream for the envs
    from global index ``env_base`` on; advances key."""
    return sd_noise_rows(env, draw_noise(key, step_noise_spec(env), batch, env_base))


def cp_draw_step_rows(env, key: torch.Tensor, batch: int, env_base: int = 0):
    """The step's CP noise rows from ``key``'s Philox stream for the envs
    from global index ``env_base`` on; advances key."""
    return cp_noise_rows(env, draw_noise(key, step_noise_spec(env), batch, env_base))


def dr_noise_rows(env, r_noise: dict):
    """DR draws no noise: no rows."""
    return ()


def dr_draw_step_rows(env, key: torch.Tensor, batch: int, env_base: int = 0):
    """No rows; advances key by one as every step's draw does."""
    return dr_noise_rows(env, draw_noise(key, step_noise_spec(env), batch, env_base))


def pe_noise_rows(env, r_noise: dict):
    """Reset noise -> PE's input rows (ball_u (2, B), recv_u (16, B))."""
    return r_noise["ball"], r_noise["recv_x"]


def pe_draw_step_rows(env, key: torch.Tensor, batch: int, env_base: int = 0):
    """The step's PE noise rows from ``key``'s Philox stream for the envs
    from global index ``env_base`` on; advances key."""
    return pe_noise_rows(env, draw_noise(key, step_noise_spec(env), batch, env_base))


# -------------------------------------------------------- plain versions
def _plain(env, unpack, pack, keys, state, action, r_noise, emit_final):
    """unpack -> the env's step_with_noise[_final] -> pack."""
    s = unpack(state, env)
    if emit_final:
        ns, obs, fobs, rew, term, trunc, info = env.step_with_noise_final(s, action, {}, r_noise)
        obs = torch.cat([obs, fobs])
    else:
        ns, obs, rew, term, trunc, info = env.step_with_noise(s, action, {}, r_noise)
    aux = torch.stack([rew, term.to(rew.dtype), trunc.to(rew.dtype)] + [info[k] for k in keys])
    return pack(ns), obs, aux


def sd_full_step_plain(env, state, action, ball_u, spawn_u, theta_u, emit_final: bool = False):
    """Plain PyTorch version of the fused SD step, over the port's own env
    functions.  Returns ``(state (57,B), obs (24 or 48,B), aux (11,B))``."""
    b = state.shape[-1]
    r_noise = {"ball": ball_u.reshape(2, K, b),
               "spawn": spawn_u.reshape(env.n_yellow, 2, K, b),
               "theta": theta_u}
    return _plain(env, unpack_sd_state, pack_ssl_state, SD_KEYS, state, action, r_noise, emit_final)


def cp_full_step_plain(env, state, action, enemy_u, emit_final: bool = False):
    """Plain PyTorch version of the fused CP step.  Returns
    ``(state (28,B), obs (14 or 28,B), aux (12,B))``."""
    return _plain(env, unpack_cp_state, pack_ssl_state, CP_KEYS, state, action,
                  {"enemy": enemy_u}, emit_final)


def dr_full_step_plain(env, state, action, emit_final: bool = False):
    """Plain PyTorch version of the fused DR step.  Returns
    ``(state (38,B), obs (21 or 42,B), aux (3,B))``."""
    pad = {"_pad": torch.zeros((1, state.shape[-1]), device=state.device)}
    return _plain(env, unpack_dr_state, pack_dr_state, DR_KEYS, state, action, pad, emit_final)


def pe_full_step_plain(env, state, action, ball_u, recv_u, emit_final: bool = False):
    """Plain PyTorch version of the fused PE step.  Returns
    ``(state (22,B), obs (16 or 32,B), aux (5,B))``."""
    return _plain(env, unpack_pe_state, pack_pe_state, PE_KEYS, state, action,
                  {"ball": ball_u, "recv_x": recv_u}, emit_final)


# ------------------------------------------------------------ the kernels
PARAM_FIELDS = (
    "dts a_lin a_ang two_pi pi two_r pair_gain "
    "ground_z fric gravity_dts neg_rest_ground bounce_min_v r_ball rbt_height "
    "face_dist contact_lo contact_hi reach_hi half_kick_w kicker_height "
    "pull_accel damping capture_speed r_sum ball_gain drib_gain "
    "max_v max_w_cmd max_w_norm max_pos nbnd kick_speed "
    "half_len half_wid gk_x half_pen_wid half_goal_wid "
    "ball_dist_scale ball_grad_scale energy_scale wheel_r "
    "j00 j01 j02 j10 j11 j12 j20 j21 j22 j30 j31 j32 max_steps "
    "sp_x_lo sp_x_span sp_y_lo sp_y_span yl_x_span yl_y_span min_d2 "
    "en_x_lo en_x_span en_y_lo en_y_span max_kick_x"
).split()


class _Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in PARAM_FIELDS]


def kernel_params(env) -> dict:
    """The kernels' constants, folded in double precision where the TPU
    kernels folded Python floats, then rounded to f32 once.  The fields of
    the tasks that ``env`` is not (spawn boxes, reward scales, the kick
    speed of PE) are zero."""
    f, cfg = env.field, env.physics_cfg
    dts = env.time_step / cfg.n_substeps
    r_ball = f.ball_radius
    contact_hi = f.rbt_distance_center_kicker + r_ball + cfg.kicker_depth_slack
    J = wheel_jacobian(f)
    half_len, half_wid = f.half_length, f.half_width
    sd = type(env) is SSLStaticDefendersEnv
    cp = type(env) is SSLContestedPossessionEnv
    return dict(
        dts=dts, a_lin=cfg.robot_accel * dts, a_ang=cfg.robot_alpha * dts,
        two_pi=2.0 * math.pi, pi=math.pi,
        two_r=2.0 * f.rbt_radius, pair_gain=-(1.0 + cfg.rest_robot_robot) * 0.5,
        ground_z=r_ball + 1e-4, fric=cfg.ball_friction_decel * dts,
        gravity_dts=cfg.gravity * dts, neg_rest_ground=-cfg.rest_ball_ground,
        bounce_min_v=cfg.ball_bounce_min_v, r_ball=r_ball, rbt_height=cfg.rbt_height,
        face_dist=f.rbt_distance_center_kicker,
        contact_lo=f.rbt_distance_center_kicker - f.rbt_kicker_thickness - r_ball,
        contact_hi=contact_hi, reach_hi=contact_hi + cfg.dribbler_reach,
        half_kick_w=f.rbt_kicker_width / 2, kicker_height=cfg.kicker_height,
        pull_accel=cfg.dribbler_pull_accel, damping=cfg.dribbler_damping,
        capture_speed=cfg.dribbler_capture_speed, r_sum=f.rbt_radius + r_ball,
        ball_gain=-(1.0 + cfg.rest_ball_robot), drib_gain=-(1.0 + cfg.rest_dribbler),
        max_v=env.max_v, max_w_cmd=env.max_w_cmd, max_w_norm=env.max_w_norm,
        max_pos=env.max_pos, nbnd=env.norm_bounds, kick_speed=env.kick_speed_x,
        half_len=half_len, half_wid=half_wid, gk_x=half_len - f.penalty_length,
        half_pen_wid=f.penalty_width / 2, half_goal_wid=f.goal_width / 2,
        ball_dist_scale=getattr(env, "ball_dist_scale", 0.0),
        ball_grad_scale=getattr(env, "ball_grad_scale", 0.0),
        energy_scale=getattr(env, "energy_scale", 0.0), wheel_r=f.rbt_wheel_radius,
        **{f"j{k}{c}": float(J[k, c]) for k in range(4) for c in range(3)},
        max_steps=float(env.max_episode_steps),
        sp_x_lo=0.2 if sd else 0.0,
        sp_x_span=(half_len - 0.1 - 0.2) if sd else 0.0,
        sp_y_lo=(-half_wid + 0.1) if sd else 0.0,
        sp_y_span=(2 * half_wid - 0.2) if sd else 0.0,
        yl_x_span=((half_len - 0.1) - 0.2) if sd else 0.0,
        yl_y_span=((half_wid - 0.1) - (-half_wid + 0.1)) if sd else 0.0,
        min_d2=0.2 * 0.2 if sd else 0.0,
        en_x_lo=f.penalty_length if cp else 0.0,
        en_x_span=half_len - 2 * f.penalty_length if cp else 0.0,
        en_y_lo=-f.penalty_width / 2 if cp else 0.0,
        en_y_span=f.penalty_width if cp else 0.0,
        max_kick_x=env.max_kick_x if type(env) is SSLPassEnduranceEnv else 0.0,
    )


_PARAMS_CACHE: dict = {}


def _params_struct(env) -> _Params:
    """The ctypes struct for ``env``'s configuration, built once per
    configuration rather than per launch."""
    k = (type(env), env.field, env.physics_cfg, env.time_step, env.max_episode_steps)
    if k not in _PARAMS_CACHE:
        _PARAMS_CACHE[k] = _Params(**kernel_params(env))
    return _PARAMS_CACHE[k]


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load()
    fields = lib.ssl_params_fields().decode().rstrip(",").split(",")
    if fields != PARAM_FIELDS:
        raise RuntimeError(
            f"csrc/ssl_task.cuh SslParams {fields} != PARAM_FIELDS {PARAM_FIELDS}"
        )
    return lib


def route(entry: str, batch: int) -> str:
    """Which kernel the fused step of C entry ``entry`` (one of
    ``ENTRIES``) launches at ``batch`` envs: ``"group"`` (8 lanes per env;
    SD and DR up to their ``GROUP_MAX_ENVS``) or ``"thread"`` (one env per
    thread; CP and PE at every batch)."""
    if entry not in ENTRIES:
        raise ValueError(f"no fused SSL step {entry!r}; one of {sorted(ENTRIES)}")
    return "group" if batch <= GROUP_MAX_ENVS.get(entry, 0) else "thread"


def routed_entry(entry: str, batch: int) -> str:
    """The C entry that the fused step of ``entry`` calls at ``batch`` envs:
    ``entry`` itself (SD's and DR's group kernel; CP's and PE's one kernel),
    or ``entry + "_one_thread"`` (SD's and DR's one-thread kernel)."""
    if route(entry, batch) == "thread" and entry in GROUP_ENTRIES:
        return entry + "_one_thread"
    return entry


def _launch(wrapper, entry: str, env, n_robots: int, state_rows: int, n_aux: int, state, action,
            noise, noise_rows, key, emit_final, env_base):
    """Check the operands, allocate the outputs and launch ``entry``'s
    kernel for the batch (:func:`route`); count the launch on ``wrapper``."""
    if env.n_robots != n_robots or env.physics_cfg.n_substeps != N_SUBSTEPS:
        raise NotImplementedError(
            f"the CUDA kernel {entry} is compiled for {n_robots} robots and "
            f"{N_SUBSTEPS} substeps; got {env.n_robots} robots, "
            f"{env.physics_cfg.n_substeps} substeps"
        )
    dev = state.device
    b = state.shape[-1]
    _build.check_operand(state, "state", state_rows, b, dev)
    _build.check_operand(action, "action", env.action_size, b, dev)
    rng_kernel = key is not None
    if rng_kernel:
        _build.check_key(key, dev)
        _build.check_env_base(env_base, b)
    else:
        for i, (t, rows) in enumerate(zip(noise, noise_rows)):
            _build.check_operand(t, f"noise[{i}]", rows, b, dev)

    entry = routed_entry(entry, b)
    lib = _library()
    st_out = torch.empty_like(state)
    obs = torch.empty((env.obs_size * (2 if emit_final else 1), b), dtype=torch.float32, device=dev)
    aux = torch.empty((n_aux, b), dtype=torch.float32, device=dev)
    # DR has no noise operands, and so no key pointer and no env_base either
    ptrs = [None if rng_kernel else t.data_ptr() for t in noise]
    base = ()
    if noise_rows:
        ptrs.append(key.data_ptr() if rng_kernel else None)
        base = (env_base,)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            int(emit_final), int(rng_kernel), ctypes.byref(_params_struct(env)),
            state.data_ptr(), action.data_ptr(), *ptrs,
            st_out.data_ptr(), obs.data_ptr(), aux.data_ptr(), *base, b,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    tracing.launched(wrapper.__name__, entry, emit_final)
    if rng_kernel:
        key[2:].add_(1)  # in-stream: the next step reads the next counter
    return st_out, obs, aux


def _dispatch(name, env, state, noise, key):
    """Which way a fused step runs: True to launch the kernel (CUDA), False
    for the plain version (CPU); raises on anything else."""
    if noise and (key is None) == (noise[0] is None):
        raise ValueError("pass exactly one of: the noise rows, key")
    if state.device.type == "cuda":
        return True
    if state.device.type != "cpu":
        raise NotImplementedError(
            f"{name} runs on CUDA (kernel) or CPU (plain version), not {state.device.type}"
        )
    return False


def sd_full_step(env, state, action, ball_u=None, spawn_u=None, theta_u=None, *,
                 key=None, emit_final: bool = False, env_base: int = 0):
    """One fused SSLStaticDefenders-v0 step.

    Noise either as input rows (``ball_u``, ``spawn_u``, ``theta_u``), or
    drawn from ``key`` (int64 ``[k0, k1, step]``, advanced by one) for the
    envs from global index ``env_base`` on (a shard of a larger batch).
    Returns ``(state, obs, aux)``.  On the card it launches the 8-lane group
    kernel up to its ``GROUP_MAX_ENVS`` (8448) envs and the one-thread
    kernel above (:func:`route`): the crossover the H100 measured (PERF.md,
    section 6).
    """
    noise = (ball_u, spawn_u, theta_u)
    if _dispatch("sd_full_step", env, state, noise, key):
        return _launch(sd_full_step, "ssl_sd_full_step", env, SD_ROBOTS, sd_state_size(),
                       3 + len(SD_KEYS), state, action, noise,
                       (2 * K, env.n_yellow * 2 * K, env.n_yellow), key, emit_final, env_base)
    if key is not None:
        noise = sd_draw_step_rows(env, key, state.shape[-1], env_base)
    return sd_full_step_plain(env, state, action, *noise, emit_final)


def cp_full_step(env, state, action, enemy_u=None, *, key=None, emit_final: bool = False,
                 env_base: int = 0):
    """One fused SSLContestedPossession-v0 step.

    Noise either as the input row block ``enemy_u`` (2, B), or drawn from
    ``key`` (advanced by one) for the envs from global index ``env_base``
    on.  Returns ``(state, obs, aux)``.
    """
    noise = (enemy_u,)
    if _dispatch("cp_full_step", env, state, noise, key):
        return _launch(cp_full_step, "ssl_cp_full_step", env, CP_ROBOTS, cp_state_size(),
                       3 + len(CP_KEYS), state, action, noise, (2,), key, emit_final, env_base)
    if key is not None:
        noise = cp_draw_step_rows(env, key, state.shape[-1], env_base)
    return cp_full_step_plain(env, state, action, *noise, emit_final)


def dr_full_step(env, state, action, *, key=None, emit_final: bool = False,
                 env_base: int = 0):
    """One fused SSLDribbling-v0 step.  It draws no noise; ``key``, where
    given (the kernel-RNG mode), is advanced by one all the same, and
    ``env_base`` (a shard's first global env index) reaches no word.  Returns
    ``(state, obs, aux)``.  On the card it launches the 8-lane group kernel
    up to its ``GROUP_MAX_ENVS`` (4096) envs and the one-thread kernel above
    (:func:`route`), the main path's 8192 envs included: the crossover the
    H100 measured on the main path's state (PERF.md, section 6)."""
    if _dispatch("dr_full_step", env, state, (), key):
        return _launch(dr_full_step, "ssl_dr_full_step", env, DR_ROBOTS, dr_state_size(), 3,
                       state, action, (), (), key, emit_final, env_base)
    if key is not None:
        dr_draw_step_rows(env, key, state.shape[-1], env_base)
    return dr_full_step_plain(env, state, action, emit_final)


def pe_full_step(env, state, action, ball_u=None, recv_u=None, *, key=None,
                 emit_final: bool = False, env_base: int = 0):
    """One fused SSLPassEndurance-v0 step.

    Noise either as input rows (``ball_u`` (2, B), ``recv_u`` (16, B)), or
    drawn from ``key`` (advanced by one) for the envs from global index
    ``env_base`` on.  Returns ``(state, obs, aux)``.
    """
    noise = (ball_u, recv_u)
    if _dispatch("pe_full_step", env, state, noise, key):
        return _launch(pe_full_step, "ssl_pe_full_step", env, PE_ROBOTS, pe_state_size(),
                       3 + len(PE_KEYS), state, action, noise, (2, N_CAND), key, emit_final, env_base)
    if key is not None:
        noise = pe_draw_step_rows(env, key, state.shape[-1], env_base)
    return pe_full_step_plain(env, state, action, *noise, emit_final)
