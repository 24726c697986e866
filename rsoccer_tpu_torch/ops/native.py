"""ctypes binding to the C++ physics oracles ``csrc/vss_physics.cpp`` and
``csrc/ssl_physics.cpp``.

The port's own copy of the JAX package's ``ops/native.py`` (which the port
cannot import): the same single-env entries, :func:`vss_step_native` and
:func:`ssl_step_native`, taking the port's ``FieldParams`` and
``PhysicsConfig``; and :func:`batched_vss_oracle` /
:func:`batched_ssl_oracle`, which walk a batch-last port state env by env
through the oracle and return a port state on the input's device — what
the kernels are held against on the card.

Each oracle is built with g++ at first use (nothing is built on import)
into ``rsoccer_tpu_torch/_build/``, under a name keyed by a hash of the
source and the flags, written to a temporary file and renamed into place:
concurrent processes, and the JAX package's binding (which builds into
``csrc/build/``), never race on one library.  A failed build raises with
g++'s output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from rsoccer_tpu_torch.core.field import FieldParams
from rsoccer_tpu_torch.core.state import (
    BallState, RobotsState, SSLCommands, VSSCommands, WorldState,
)
from rsoccer_tpu_torch.physics.config import PhysicsConfig

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG.parent / "csrc"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_P = ctypes.c_void_p


class _CField(ctypes.Structure):
    _fields_ = [
        ("half_length", ctypes.c_float),
        ("half_width", ctypes.c_float),
        ("goal_half_wid", ctypes.c_float),
        ("goal_depth", ctypes.c_float),
        ("ball_radius", ctypes.c_float),
        ("rbt_radius", ctypes.c_float),
        ("wheel_radius", ctypes.c_float),
        ("max_wheel_rad_s", ctypes.c_float),
    ]


class _CPhysics(ctypes.Structure):
    _fields_ = [
        ("n_substeps", ctypes.c_int),
        ("robot_accel", ctypes.c_float),
        ("robot_alpha", ctypes.c_float),
        ("lateral_decay", ctypes.c_float),
        ("ball_friction_decel", ctypes.c_float),
        ("rest_ball_wall", ctypes.c_float),
        ("rest_ball_robot", ctypes.c_float),
        ("rest_robot_robot", ctypes.c_float),
        ("gravity", ctypes.c_float),
        ("rest_ball_ground", ctypes.c_float),
        ("ball_bounce_min_v", ctypes.c_float),
        ("rbt_height", ctypes.c_float),
    ]


class _CSSLField(ctypes.Structure):
    _fields_ = [
        ("ball_radius", ctypes.c_float),
        ("rbt_radius", ctypes.c_float),
        ("wheel_radius", ctypes.c_float),
        ("max_wheel_rad_s", ctypes.c_float),
        ("wheel_angle_deg", ctypes.c_float * 4),
        ("rbt_distance_center_kicker", ctypes.c_float),
        ("rbt_kicker_thickness", ctypes.c_float),
        ("rbt_kicker_width", ctypes.c_float),
    ]


class _CSSLPhysics(ctypes.Structure):
    _fields_ = [
        ("n_substeps", ctypes.c_int),
        ("robot_accel", ctypes.c_float),
        ("robot_alpha", ctypes.c_float),
        ("ball_friction_decel", ctypes.c_float),
        ("rest_ball_robot", ctypes.c_float),
        ("rest_dribbler", ctypes.c_float),
        ("rest_robot_robot", ctypes.c_float),
        ("gravity", ctypes.c_float),
        ("rest_ball_ground", ctypes.c_float),
        ("ball_bounce_min_v", ctypes.c_float),
        ("rbt_height", ctypes.c_float),
        ("kicker_height", ctypes.c_float),
        ("kicker_depth_slack", ctypes.c_float),
        ("dribbler_pull_accel", ctypes.c_float),
        ("dribbler_damping", ctypes.c_float),
        ("dribbler_capture_speed", ctypes.c_float),
        ("dribbler_reach", ctypes.c_float),
    ]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cpp``'s oracle is built: keyed by the source and
    the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_oracle_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def _load(name: str, entry: str, n_ptrs: int) -> ctypes.CDLL:
    """Build ``csrc/<name>.cpp`` if needed and load it; ``entry`` takes
    (field*, physics*, float dt, int n, then ``n_ptrs`` float pointers)."""
    lib_path = library_path(name)
    if not lib_path.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH: the C++ oracle {name}.cpp cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {name}.cpp:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, entry)
    fn.argtypes = [_P, _P, ctypes.c_float, ctypes.c_int] + [_P] * n_ptrs
    fn.restype = None
    return lib


def _vss_structs(field: FieldParams, cfg: PhysicsConfig):
    cf = _CField(
        half_length=field.half_length,
        half_width=field.half_width,
        goal_half_wid=field.goal_width / 2,
        goal_depth=field.goal_depth,
        ball_radius=field.ball_radius,
        rbt_radius=field.rbt_radius,
        wheel_radius=field.rbt_wheel_radius,
        max_wheel_rad_s=field.max_wheel_rad_s,
    )
    cp = _CPhysics(**{name: getattr(cfg, name) for name, _ in _CPhysics._fields_})
    return cf, cp


def _ssl_structs(field: FieldParams, cfg: PhysicsConfig):
    cf = _CSSLField(
        ball_radius=field.ball_radius,
        rbt_radius=field.rbt_radius,
        wheel_radius=field.rbt_wheel_radius,
        max_wheel_rad_s=field.max_wheel_rad_s,
        wheel_angle_deg=(ctypes.c_float * 4)(
            field.rbt_wheel0_angle, field.rbt_wheel1_angle,
            field.rbt_wheel2_angle, field.rbt_wheel3_angle,
        ),
        rbt_distance_center_kicker=field.rbt_distance_center_kicker,
        rbt_kicker_thickness=field.rbt_kicker_thickness,
        rbt_kicker_width=field.rbt_kicker_width,
    )
    cp = _CSSLPhysics(**{name: getattr(cfg, name) for name, _ in _CSSLPhysics._fields_})
    return cf, cp


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check_shapes(ball, robots, commands, n_cmd: int) -> int:
    n = robots.shape[0]
    if ball.shape != (6,) or robots.shape != (n, 6) or commands.shape != (n, n_cmd):
        raise ValueError(f"want ball (6,), robots (N, 6), commands (N, {n_cmd}); got "
                         f"{ball.shape}, {robots.shape}, {commands.shape}")
    return n


def vss_step_native(
    field: FieldParams,
    cfg: PhysicsConfig,
    dt: float,
    ball: np.ndarray,  # (6,) x, y, z, vx, vy, vz — modified in place
    robots: np.ndarray,  # (N, 6) x, y, theta, vx, vy, vtheta — in place
    commands: np.ndarray,  # (N, 2) wheel rad/s
) -> np.ndarray:
    """Steps one VSS world in place; returns the achieved (N, 2) wheel
    speeds."""
    lib = _load("vss_physics", "vss_step", 4)
    cf, cp = _vss_structs(field, cfg)
    n = _check_shapes(ball, robots, commands, 2)
    ball_c = np.ascontiguousarray(ball, np.float32)
    robots_c = np.ascontiguousarray(robots, np.float32)
    cmds_c = np.ascontiguousarray(commands, np.float32)
    out_wheels = np.zeros((n, 2), np.float32)
    lib.vss_step(ctypes.byref(cf), ctypes.byref(cp), dt, n,
                 _ptr(ball_c), _ptr(robots_c), _ptr(cmds_c), _ptr(out_wheels))
    ball[:] = ball_c
    robots[:] = robots_c
    return out_wheels


def ssl_step_native(
    field: FieldParams,
    cfg: PhysicsConfig,
    dt: float,
    ball: np.ndarray,  # (6,) x, y, z, vx, vy, vz — modified in place
    robots: np.ndarray,  # (N, 6) x, y, theta, vx, vy, vtheta — in place
    commands: np.ndarray,  # (N, 11) [wheel_speed, vw0..3, vx, vy, vtheta,
    #                                 kick_v_x, kick_v_z, dribbler]
):
    """Steps one SSL world in place; returns (infrared (N,), v_wheel (N, 4))."""
    lib = _load("ssl_physics", "ssl_step", 5)
    cf, cp = _ssl_structs(field, cfg)
    n = _check_shapes(ball, robots, commands, 11)
    ball_c = np.ascontiguousarray(ball, np.float32)
    robots_c = np.ascontiguousarray(robots, np.float32)
    cmds_c = np.ascontiguousarray(commands, np.float32)
    out_ir = np.zeros((n,), np.float32)
    out_wheels = np.zeros((n, 4), np.float32)
    lib.ssl_step(ctypes.byref(cf), ctypes.byref(cp), dt, n,
                 _ptr(ball_c), _ptr(robots_c), _ptr(cmds_c), _ptr(out_ir), _ptr(out_wheels))
    ball[:] = ball_c
    robots[:] = robots_c
    return out_ir > 0.5, out_wheels


def _env_rows(world: WorldState):
    """(B, 6) ball and (B, N, 6) robot rows, f32, C order, on the host."""
    b, rb = world.ball, world.robots
    ball = torch.stack([b.x, b.y, b.z, b.v_x, b.v_y, b.v_z]).T
    robots = torch.stack([rb.x, rb.y, rb.theta, rb.v_x, rb.v_y, rb.v_theta]).permute(2, 1, 0)
    as_np = lambda t: np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())  # noqa: E731
    return as_np(ball), as_np(robots)


def _walk(fn, field_s, cfg_s, dt: float, rows, outs):
    """Call the oracle entry ``fn`` once per env on row ``e`` of each array
    of ``rows`` (in place) and ``outs``."""
    arrays = (*rows, *outs)
    bases = [_ptr(a) for a in arrays]
    strides = [a.strides[0] for a in arrays]
    pf, pc, n = ctypes.byref(field_s), ctypes.byref(cfg_s), rows[1].shape[1]
    for e in range(rows[0].shape[0]):
        fn(pf, pc, dt, n, *(p + e * s for p, s in zip(bases, strides)))


def _world_from_rows(world: WorldState, ball, robots, infrared, v_wheel) -> WorldState:
    dev = world.ball.x.device
    b = torch.from_numpy(ball.T.copy()).to(dev)
    r = torch.from_numpy(robots.transpose(2, 1, 0).copy()).to(dev)
    return WorldState(
        ball=BallState(*b.unbind(0)),
        robots=RobotsState(*r.unbind(0), infrared=infrared.to(dev),
                           v_wheel=torch.from_numpy(v_wheel.transpose(1, 2, 0).copy()).to(dev)),
    )


def batched_vss_oracle(world: WorldState, commands: VSSCommands, field: FieldParams,
                       cfg: PhysicsConfig, dt: float) -> WorldState:
    """One VSS step of every env of a batch-last port ``world`` through
    ``csrc/vss_physics.cpp``, env by env: the next world on ``world``'s
    device, ``v_wheel`` the oracle's achieved wheel speeds in slots 0-1
    (2-3 zero), ``infrared`` as given."""
    lib = _load("vss_physics", "vss_step", 4)
    cf, cp = _vss_structs(field, cfg)
    ball, robots = _env_rows(world)
    cmds = np.ascontiguousarray(
        torch.stack([commands.v_wheel0, commands.v_wheel1]).permute(2, 1, 0)
        .detach().to("cpu", torch.float32).numpy())
    wheels = np.zeros((*robots.shape[:2], 2), np.float32)
    _walk(lib.vss_step, cf, cp, dt, (ball, robots, cmds), (wheels,))
    wheels = np.concatenate([wheels, np.zeros_like(wheels)], axis=-1)  # the SSL-shaped (N, 4) slots
    return _world_from_rows(world, ball, robots, world.robots.infrared, wheels)


def ssl_command_rows(commands: SSLCommands) -> np.ndarray:
    """Port ``SSLCommands`` -> the oracle's (B, N, 11) command rows:
    [wheel_speed, vw0..3, vx, vy, vtheta, kick_v_x, kick_v_z, dribbler]."""
    c = commands
    rows = torch.cat([
        c.wheel_speed.to(torch.float32)[:, None], c.v_wheel.to(torch.float32),
        torch.stack([c.v_x, c.v_y, c.v_theta, c.kick_v_x, c.kick_v_z]).transpose(0, 1).to(torch.float32),
        c.dribbler.to(torch.float32)[:, None],
    ], dim=1)  # (N, 11, B)
    return np.ascontiguousarray(rows.permute(2, 0, 1).detach().cpu().numpy())


def batched_ssl_oracle(world: WorldState, commands: SSLCommands, field: FieldParams,
                       cfg: PhysicsConfig, dt: float) -> WorldState:
    """One SSL step of every env of a batch-last port ``world`` through
    ``csrc/ssl_physics.cpp``, env by env: the next world on ``world``'s
    device, with the oracle's infrared and achieved wheel speeds."""
    lib = _load("ssl_physics", "ssl_step", 5)
    cf, cp = _ssl_structs(field, cfg)
    ball, robots = _env_rows(world)
    n_env, n = robots.shape[:2]
    ir = np.zeros((n_env, n), np.float32)
    wheels = np.zeros((n_env, n, 4), np.float32)
    _walk(lib.ssl_step, cf, cp, dt, (ball, robots, ssl_command_rows(commands)), (ir, wheels))
    return _world_from_rows(world, ball, robots, torch.from_numpy(ir.T > 0.5), wheels)


# the oracle protocol's tolerances per step (tests/test_native_oracle.py)
ORACLE_ATOL = 2e-4  # ball and robot leaves
ORACLE_WHEEL_ATOL = 5e-3  # achieved wheel speeds


def world_errors(got: WorldState, want: WorldState) -> dict:
    """Worst absolute error per leaf (``"ball.x"`` ... ``"robots.v_wheel"``;
    theta across the +-pi wrap; ``"robots.infrared"``: the count of
    differing flags)."""
    out = {}
    for part in ("ball", "robots"):
        g_part, w_part = getattr(got, part), getattr(want, part)
        for name in type(g_part)._fields:
            g, w = getattr(g_part, name), getattr(w_part, name).to(getattr(g_part, name).device)
            if name == "infrared":
                out[f"{part}.{name}"] = int((g != w).sum())
                continue
            d = g.double() - w.double()
            if name == "theta":
                d = torch.remainder(d + np.pi, 2 * np.pi) - np.pi
            out[f"{part}.{name}"] = float(d.abs().max())
    return out


def check_oracle(errors: dict, tag: str = "") -> None:
    """Raise unless ``world_errors`` are within the oracle protocol:
    ``ORACLE_ATOL`` on ball and robots, ``ORACLE_WHEEL_ATOL`` on wheel
    speeds, infrared exact."""
    for name, err in errors.items():
        tol = 0 if name == "robots.infrared" else (
            ORACLE_WHEEL_ATOL if name == "robots.v_wheel" else ORACLE_ATOL)
        if not err <= tol:
            raise AssertionError(f"{tag} {name}: error {err} against the C++ oracle exceeds {tol}")
