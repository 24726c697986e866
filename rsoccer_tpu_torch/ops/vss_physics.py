"""VSS physics only — one control step of B worlds as ONE CUDA kernel launch.

Replaces the TPU kernel ``rsoccer_tpu/ops/pallas_vss.py:37``
(``make_pallas_vss_physics``): 5 substeps of the differential-drive world
(drive, dense robot contacts, wall clamp, ball friction and vertical axis,
ball-robot contacts, goal-pocket walls) on stacked arrays, for N = 1..10
robots.  The kernels are in ``csrc/vss_physics.cu`` (the VSS substep of
``csrc/vss_world.cuh``, shared with the fused VSS step); :func:`route`
picks one per launch, as ``ops/vss_full.route`` does: one env on a group
of lanes (N = 6 on 8 lanes up to ``VSS_GROUP_MAX_ENVS`` = 24576 envs, N =
10 on 16 up to ``VSS_10_GROUP_MAX_ENVS`` = 16384) or one env per thread
(every other N, and N = 6 and 10 above those batches; for 7-10 robots
above ``THREAD_UNCAPPED_MAX_ENVS`` = 49152 envs its register-capped
variant).  The crossovers were measured in turns on the card (on the
redesigned one-thread kernel): at N = 6 the group kernel wins at 24576
envs and loses at 32768, at N = 10 it wins at 16384 and loses from 24576;
at N = 10 the uncapped one-thread kernel wins up to 49152 envs and the
capped one from 65536 (97-98 against 120 us there, 185-189 against 194-197
at 131072).  All give the same bits at N = 6 and 10.

Arrays, as the TPU kernel's: robots ``(6, N, B)`` rows [x, y, theta, v_x,
v_y, v_theta], ball ``(6, B)`` [x, y, z, v_x, v_y, v_z], wheel commands
``(2, N, B)`` [left, right] in rad/s.

:func:`vss_physics` runs the plain version :func:`vss_physics_plain`
(``physics/vss.make_vss_step`` on the same arrays) only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
Each launch counts in ``utils/tracing``'s table under ``vss_physics``, by
C entry (``vss_physics_step``: the group kernels,
``vss_physics_step_one_thread``: the one-thread kernel,
``vss_physics_step_one_thread_capped``: its capped variant).
:func:`world_step` is the ``physics/vss`` step's signature over it, which
``BatchedEnv(..., fused_physics=True)`` runs between the task's pre- and
post-physics.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from rsoccer_tpu_torch.core.state import BallState, RobotsState, VSSCommands, WorldState
from rsoccer_tpu_torch.ops import _build
from rsoccer_tpu_torch.physics.vss import HALF_AXLE, achieved_wheel_speeds, make_vss_step
from rsoccer_tpu_torch.utils import tracing

N_ROBOTS = range(1, 11)  # robot counts the kernels run
N_SUBSTEPS = 5  # compiled into the kernels
# Up to this many envs N = 6 launches the 8-lane group kernel, above it the
# one-thread kernel: measured in turns on the card, the group kernel wins
# at 24576 envs (23.03 against 23.44 us) and loses at 32768 (30.02 against
# 24.88; PERF.md, section 6).
VSS_GROUP_MAX_ENVS = 24576
# Up to this many envs N = 10 (5v5) launches the 16-lane group kernel,
# above it the one-thread kernel: measured in turns on the card, the group
# kernel wins at 16384 envs (39.07 against 47.52 us) and, since the
# one-thread kernel's redesign, loses from 24576 on (56.71 against 49.82;
# PERF.md, section 6).
VSS_10_GROUP_MAX_ENVS = 16384
# robot count -> the batch up to which it launches its group kernel; the
# counts not listed have only the one-thread kernel
GROUP_MAX_ENVS = {6: VSS_GROUP_MAX_ENVS, 10: VSS_10_GROUP_MAX_ENVS}
# Robot counts whose one-thread kernel has a register-capped variant (128
# registers, 16 warps per SM), and the batch up to which they launch the
# uncapped one (168 registers at N = 10, 12 warps): measured in turns on
# the card at N = 10, the uncapped kernel wins up to 49152 envs and the
# capped one from 65536 on (PERF.md, section 6)
THREAD_CAPPED_ROBOTS = range(7, 11)
THREAD_UNCAPPED_MAX_ENVS = 49152

PARAM_FIELDS = (
    "dts lat_keep a_lin a_ang max_wheel wheel_r two_half_axle half_len half_wid "
    "goal_half hl_goal r_ball two_r r_sum xl yl ground_z fric gravity_dts "
    "neg_rest_ground bounce_min_v rbt_height pair_gain ball_gain neg_rest_wall two_pi pi"
).split()


class _Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in PARAM_FIELDS]


def kernel_params(env) -> dict:
    """The kernel's constants, folded in double precision where
    physics/vss.py folds Python floats, then rounded to f32 once."""
    f, cfg = env.field, env.physics_cfg
    dts = env.time_step / cfg.n_substeps
    return dict(
        dts=dts, lat_keep=math.exp(-cfg.lateral_decay * dts),
        a_lin=cfg.robot_accel * dts, a_ang=cfg.robot_alpha * dts,
        max_wheel=f.max_wheel_rad_s, wheel_r=f.rbt_wheel_radius, two_half_axle=2.0 * HALF_AXLE,
        half_len=f.half_length, half_wid=f.half_width, goal_half=f.goal_width / 2,
        hl_goal=f.half_length + f.goal_depth, r_ball=f.ball_radius, two_r=2.0 * f.rbt_radius,
        r_sum=f.rbt_radius + f.ball_radius,
        xl=f.half_length - f.rbt_radius, yl=f.half_width - f.rbt_radius,
        ground_z=f.ball_radius + 1e-4, fric=cfg.ball_friction_decel * dts,
        gravity_dts=cfg.gravity * dts, neg_rest_ground=-cfg.rest_ball_ground,
        bounce_min_v=cfg.ball_bounce_min_v, rbt_height=cfg.rbt_height,
        pair_gain=-(1.0 + cfg.rest_robot_robot) * 0.5, ball_gain=-(1.0 + cfg.rest_ball_robot),
        neg_rest_wall=-cfg.rest_ball_wall, two_pi=2.0 * math.pi, pi=math.pi,
    )


_PARAMS_CACHE: dict = {}


def _params_struct(env) -> _Params:
    k = (env.field, env.physics_cfg, env.time_step)
    if k not in _PARAMS_CACHE:
        _PARAMS_CACHE[k] = _Params(**kernel_params(env))
    return _PARAMS_CACHE[k]


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load()
    fields = lib.vss_physics_params_fields().decode().rstrip(",").split(",")
    if fields != PARAM_FIELDS:
        raise RuntimeError(
            f"csrc/vss_physics.cu VssPhysParams {fields} != PARAM_FIELDS {PARAM_FIELDS}"
        )
    return lib


def _world(robots, ball, wheel_r: float, infrared=None) -> WorldState:
    """Stacked arrays -> WorldState; v_wheel from physics/vss's epilogue."""
    x, y, theta, vx, vy, w = robots
    return WorldState(
        ball=BallState(*ball),
        robots=RobotsState(
            x=x, y=y, theta=theta, v_x=vx, v_y=vy, v_theta=w,
            infrared=torch.zeros_like(x, dtype=torch.bool) if infrared is None else infrared,
            v_wheel=achieved_wheel_speeds(vx, vy, theta, w, wheel_r),
        ),
    )


def _stack(world: WorldState):
    rb, b = world.robots, world.ball
    return (torch.stack([rb.x, rb.y, rb.theta, rb.v_x, rb.v_y, rb.v_theta]),
            torch.stack([b.x, b.y, b.z, b.v_x, b.v_y, b.v_z]))


def vss_physics_plain(env, robots, ball, cmd):
    """Plain PyTorch version: ``physics/vss.make_vss_step`` on the arrays."""
    step = make_vss_step(env.field, env.physics_cfg, env.time_step)
    world = step(_world(robots, ball, env.field.rbt_wheel_radius), VSSCommands(cmd[0], cmd[1]))
    return _stack(world)


def route(env, batch: int) -> str:
    """Which kernel a physics step of ``batch`` envs of ``env`` launches:
    ``"group"`` (N = 6 on 8 lanes per env up to ``VSS_GROUP_MAX_ENVS`` envs,
    N = 10 on 16 up to ``VSS_10_GROUP_MAX_ENVS``) or ``"thread"`` (one thread
    per env).  Raises ``NotImplementedError`` outside the robot counts the
    kernels run."""
    n = env.n_robots
    if n not in N_ROBOTS or env.physics_cfg.n_substeps != N_SUBSTEPS:
        raise NotImplementedError(
            f"the CUDA kernels vss_physics run {N_ROBOTS.start}-{N_ROBOTS.stop - 1} robots "
            f"with {N_SUBSTEPS} substeps; got {n} robots, {env.physics_cfg.n_substeps} substeps"
        )
    return "group" if batch <= GROUP_MAX_ENVS.get(n, 0) else "thread"


def routed_entry(env, batch: int) -> str:
    """The C entry that a physics step of ``batch`` envs launches
    (:func:`route`): ``vss_physics_step`` (the group kernels),
    ``vss_physics_step_one_thread``, or, for 7-10 robots above
    ``THREAD_UNCAPPED_MAX_ENVS`` envs, ``vss_physics_step_one_thread_capped``."""
    if route(env, batch) == "group":
        return "vss_physics_step"
    capped = env.n_robots in THREAD_CAPPED_ROBOTS and batch > THREAD_UNCAPPED_MAX_ENVS
    return "vss_physics_step_one_thread_capped" if capped else "vss_physics_step_one_thread"


def _launch(env, robots, ball, cmd):
    n = env.n_robots
    dev = robots.device
    b = robots.shape[-1]
    entry = routed_entry(env, b)
    _build.check_operand(robots, "robots", (6, n), b, dev)
    _build.check_operand(ball, "ball", 6, b, dev)
    _build.check_operand(cmd, "cmd", (2, n), b, dev)
    lib = _library()
    rb_out = torch.empty_like(robots)
    ball_out = torch.empty_like(ball)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            ctypes.byref(_params_struct(env)), robots.data_ptr(), ball.data_ptr(), cmd.data_ptr(),
            rb_out.data_ptr(), ball_out.data_ptr(), n, b, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    tracing.launched("vss_physics", entry, False)
    return rb_out, ball_out


def vss_physics(env, robots, ball, cmd):
    """One physics step of B VSS worlds: ``robots (6,N,B), ball (6,B),
    cmd (2,N,B) -> (robots, ball)``."""
    if robots.device.type == "cuda":
        return _launch(env, robots, ball, cmd)
    if robots.device.type != "cpu":
        raise NotImplementedError(
            f"vss_physics runs on CUDA (kernel) or CPU (plain version), not {robots.device.type}"
        )
    return vss_physics_plain(env, robots, ball, cmd)



def world_step(env, world: WorldState, commands) -> WorldState:
    """``physics/vss``'s ``step(world, commands)`` through
    :func:`vss_physics`; the achieved wheel speeds are recomputed from the
    result as physics/vss.py's epilogue does."""
    robots, ball = _stack(world)
    rb, bl = vss_physics(env, robots, ball, torch.stack([commands.v_wheel0, commands.v_wheel1]))
    return _world(rb, bl, env.field.rbt_wheel_radius, world.robots.infrared)
