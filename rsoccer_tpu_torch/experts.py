"""Scripted expert policies (state-based, branch-free, batched).

Port of ``rsoccer_tpu/experts.py`` on batch-last tensors: each expert
takes the batched structured state of its task (``DribblingState``,
``SDState``, ``PEState``: ball fields ``(B,)``, robot fields ``(N, B)``)
and returns actions ``(A, B)`` in [-1, 1].  The JAX package vmaps a
single-env function; here the per-env scalars are ``(B,)`` rows and
StaticDefenders' ``(K, 6)`` lane/defender matrices are ``(K, 6, B)``.  On
the fused path the state is the packed ``(S, B)`` tensor: read it through
``BatchedEnv.unpack_state`` first (``infrared`` is then the kicker-face
predicate of the packed state, as in the JAX package's ``_unpack_world``).

They prove by construction that each task is completable under the
physics (``tests/test_torch_experts.py``), and label the states that
``tools/bc_warmstart.py`` clones.  ``EXPERTS`` maps an env id to a
factory ``env -> expert(state)``.

Each expert is written once, as ``_<task>(state, ...) -> (action,
gates)``: ``gates`` holds the signed margin of every strict comparison
the expert branches on that involves a computed quantity (positive on the
side the comparison is true, or distance to the angle wrap's seam; a
sign test of a raw state value, like SD's ``ry > 0``, rounds nowhere), so
a test can tell a lane that sits on a threshold from one that disagrees.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rsoccer_tpu_torch.envs.ssl_dribbling import MARGIN, NODES

_FACE = 0.115  # ball-hold distance: rbt_distance_center_kicker + ball radius


def _wrap(a):
    """Angle to [-pi, pi): floor-mod, as ``jnp``'s ``%`` (not ``fmod``)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def _seam(a):
    """Distance of a wrapped angle from the wrap's seam at +-pi."""
    return math.pi - a.abs()


# SD's candidate aims, jnp.linspace(-0.8, 0.8, 9) as XLA computes it in
# f32 (its simplifier folds the step into the stop): torch.linspace and
# numpy's f64 rounding are each an ulp off on three of the nine
_AIMS_9 = np.array([-0.8, -0.6, -0.40000004, -0.19999999, 0.0, 0.19999999, 0.4, 0.6, 0.8],
                   np.float32)


def _aims(n: int) -> np.ndarray:
    """``n`` aims across [-0.8, 0.8]: the default nine bit for bit as the
    JAX package's, any other count within an ulp of 0.8 of it."""
    return _AIMS_9 if n == 9 else np.linspace(-0.8, 0.8, n, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant table as an f32 tensor on ``device``, copied there once
    (a copy per step from pageable host memory would wait on the card)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


_GATE_X = (-0.75, -1.25, -1.75, -2.50, -1.75, -2.50, -1.75, -1.75)
_W_LO = (NODES[1], NODES[2], NODES[3], NODES[3] - MARGIN,
         NODES[3], NODES[3] - MARGIN, NODES[3], NODES[3])
_W_HI = (NODES[0], NODES[1], NODES[2], NODES[3],
         NODES[2], NODES[3], NODES[2], NODES[2])


def dribbling_gate(count):
    """Gate geometry for the crossing the automaton expects at ``count``
    (B,) int: (center x, window lo/hi, downward?), each (B,) — tables match
    the curriculum shaping (envs/ssl_dribbling.py)."""
    onehot = torch.arange(8, device=count.device)[:, None] == count[None]

    def sel8(table):  # one nonzero term: exact
        return torch.where(onehot, _const(table, count.device)[:, None], 0.0).sum(0)

    downward = (count == 0) | ((count >= 2) & (count % 2 == 0))
    return sel8(_GATE_X), sel8(_W_LO), sel8(_W_HI), downward


def _dribbling(state, carry_speed=1.2, dip_speed=0.6, fetch_speed=1.5,
               kp=3.0, kw=5.0, w_max=6.0, lane=0.35):
    rb = state.world.robots
    rx, ry, theta = rb.x[0], rb.y[0], rb.theta[0]
    bx, by = state.world.ball.x, state.world.ball.y
    gx, w_lo, w_hi, downward = dribbling_gate(state.checkpoints)

    sign = torch.where(downward, 1.0, -1.0)  # approach side of the axis
    lane_y = sign * lane

    c, s = torch.cos(theta), torch.sin(theta)
    fx, fy = rx + _FACE * c, ry + _FACE * s
    d_ball = torch.hypot(fx - bx, fy - by)
    has_ball = d_ball < 0.05

    # dive mode: robot center inside the inset window, or committed (ball
    # already descending past the lane) inside the full window
    in_zone = (rx > w_lo + 0.15) & (rx < w_hi - 0.15)
    committed = sign * by < lane - 0.12
    dive = has_ball & (in_zone | (committed & (rx > w_lo) & (rx < w_hi)))

    dive_theta = -sign * (math.pi / 2)  # perpendicular heading
    dive_err = _wrap(dive_theta - theta)
    push = torch.clamp(torch.cos(dive_err), 0.0, 1.0)
    dive_vx = torch.clamp(kp * (gx - bx), -0.4, 0.4)
    dive_vy = -sign * dip_speed * push

    # climb: face-point control onto the lane; cruise: robot-center control
    # toward the gate center
    on_lane = torch.abs(by - lane_y) < 0.08
    nav_x = torch.where(has_ball & on_lane, gx, bx)
    nav_y = torch.where(has_ball, lane_y, by)
    px = torch.where(has_ball & on_lane, rx, fx)
    py = torch.where(has_ball & on_lane, ry, fy)
    vx = kp * (nav_x - px)
    vy = kp * (nav_y - py)
    near = torch.abs(rx - gx) < 0.45
    speed_cap = torch.where(
        has_ball, torch.where(near, dip_speed, carry_speed), fetch_speed
    )
    v_norm = torch.hypot(vx, vy)
    scale = torch.clamp_max(speed_cap / torch.clamp_min(v_norm, 1e-8), 1.0)
    vx, vy = vx * scale, vy * scale
    cruise_theta = torch.atan2(nav_y - ry, nav_x - rx)
    cruise_err = _wrap(cruise_theta - theta)

    out_vx = torch.where(dive, dive_vx, vx)
    out_vy = torch.where(dive, dive_vy, vy)
    err = torch.where(dive, dive_err, cruise_err)
    w = torch.clamp(kw * err, -w_max, w_max)

    # env action units: global v / max_v (2.5), v_theta / 10, dribbler on
    action = torch.stack([out_vx / 2.5, out_vy / 2.5, w / 10.0, torch.ones_like(w)])
    gates = {
        "has_ball": 0.05 - d_ball,
        "zone_lo": rx - (w_lo + 0.15), "zone_hi": (w_hi - 0.15) - rx,
        "committed": (lane - 0.12) - sign * by,
        "window_lo": rx - w_lo, "window_hi": w_hi - rx,
        "on_lane": 0.08 - torch.abs(by - lane_y),
        "near": 0.45 - torch.abs(rx - gx),
        "dive_seam": _seam(dive_err), "cruise_seam": _seam(cruise_err),
    }
    return torch.clamp(action, -1.0, 1.0), gates


def dribbling_expert(state, carry_speed=1.2, dip_speed=0.6, fetch_speed=1.5,
                     kp=3.0, kw=5.0, w_max=6.0, lane=0.35):
    """Scripted SSLDribbling policy: state -> action (4, B) in [-1, 1].

    Three carry modes, selected branch-free: climb (move the ball onto the
    approach lane, |y| = ``lane``, on the side the crossing must come
    from), cruise (follow the lane toward the gate center, decelerating
    on approach), dive (inside the gate window, tested on the robot x:
    rotate to the course-perpendicular heading nearly in place, then push
    through at ``dip_speed`` with the ball's x servoed onto the gate)."""
    return _dribbling(state, carry_speed, dip_speed, fetch_speed, kp, kw, w_max, lane)[0]


def _static_defenders(state, field, kp=3.0, kw=5.0, w_max=6.0, fetch_speed=1.5,
                      carry_speed=0.7, avoid_radius=0.45, avoid_gain=3.0, brake=40.0,
                      w_tol=0.5, n_targets=9):
    f = field
    rb = state.world.robots
    rx, ry, theta, w = rb.x[0], rb.y[0], rb.theta[0], rb.v_theta[0]
    bx, by = state.world.ball.x, state.world.ball.y
    dx, dy = rb.x[1:], rb.y[1:]  # (6, B) static defenders

    half_len, half_wid = f.half_length, f.half_width
    half_goal = f.goal_width / 2

    # ---- 1. widest shooting lane: K candidate aims, axis 0
    ty = (_const(tuple(_aims(n_targets).tolist()), bx.device) * half_goal)[:, None]  # (K, 1)
    gx = half_len + 0.02
    sx_ = (gx - bx).expand(n_targets, -1)  # (K, B): same x reach for every lane
    sy_ = ty - by  # (K, B)
    seg_len2 = torch.clamp_min(sx_**2 + sy_**2, 1e-6)
    # projection of each defender onto each segment: (K, 6, B)
    t = ((dx[None] - bx) * sx_[:, None] + (dy[None] - by) * sy_[:, None]) / seg_len2[:, None]
    t = torch.clamp(t, 0.0, 1.0)
    px = bx + t * sx_[:, None]
    py = by + t * sy_[:, None]
    clr = torch.hypot(dx[None] - px, dy[None] - py).amin(1)  # (K, B) lane clearance
    score = clr - 0.02 * torch.abs(ty) / max(half_goal, 1e-6)
    # soft lane choice (an argmax flips the aim under tiny obs changes and
    # makes the mapping un-clonable)
    wts = torch.softmax(score / 0.08, dim=0)
    aim_y = torch.sum(wts * ty, dim=0)

    shot_dir = torch.atan2(aim_y - by, gx - bx)  # ball -> goal lane
    c_dir, s_dir = torch.cos(shot_dir), torch.sin(shot_dir)

    # ---- 2. fetch
    c, s = torch.cos(theta), torch.sin(theta)
    fx, fy = rx + _FACE * c, ry + _FACE * s
    has_ball = rb.infrared[0]

    pre_x, pre_y = bx - 0.14 * c_dir, by - 0.14 * s_dir  # behind the ball
    d_pre = torch.hypot(rx - pre_x, ry - pre_y)
    along = (rx - bx) * c_dir + (ry - by) * s_dir
    behind = (d_pre < 0.12) | (along < -0.05)
    tgt_x = torch.where(behind, bx, pre_x)
    tgt_y = torch.where(behind, by, pre_y)
    vx_f = kp * (tgt_x - fx)
    vy_f = kp * (tgt_y - fy)
    fetch_theta = torch.atan2(by - ry, bx - rx)

    # ---- 3. carry / aim
    err = _wrap(shot_dir - theta)
    fetch_err = _wrap(fetch_theta - theta)
    aligned = torch.clamp(torch.cos(err), 0.0, 1.0) ** 2
    vx_c = carry_speed * aligned * c_dir
    vy_c = carry_speed * aligned * s_dir

    vx = torch.where(has_ball, vx_c, vx_f)
    vy = torch.where(has_ball, vy_c, vy_f)
    head_err = torch.where(has_ball, err, fetch_err)

    # defender repulsion (both phases)
    dd = torch.hypot(rx - dx, ry - dy)  # (6, B)
    push = torch.clamp_min(avoid_radius - dd, 0.0) / avoid_radius
    vx = vx + avoid_gain * torch.sum(push * (rx - dx) / torch.clamp_min(dd, 1e-3), dim=0)
    vy = vy + avoid_gain * torch.sum(push * (ry - dy) / torch.clamp_min(dd, 1e-3), dim=0)

    # ---- 5. safety clamps: a proportional barrier on the GK area (terminal
    # for the robot), side entry barred the same way, then the field margins
    gk_limit = half_len - f.penalty_length - 0.15
    band_hi = f.penalty_width / 2 + 0.12
    in_gk_band = torch.abs(ry) < band_hi
    vx = torch.where(in_gk_band, torch.minimum(vx, 4.0 * (gk_limit - rx)), vx)
    in_deep = rx > gk_limit
    vy = torch.where(in_deep & (ry > 0), torch.maximum(vy, -4.0 * (ry - band_hi)), vy)
    vy = torch.where(in_deep & (ry <= 0), torch.minimum(vy, 4.0 * (-ry - band_hi)), vy)
    vx = torch.maximum(vx, 4.0 * (0.05 - rx))
    vy = torch.where(
        torch.abs(ry) > half_wid - 0.15,
        torch.where(ry > 0, torch.clamp_max(vy, 0.0), torch.clamp_min(vy, 0.0)),
        vy,
    )

    v_norm = torch.hypot(vx, vy)
    cap = torch.where(has_ball, carry_speed, fetch_speed)
    scale = torch.clamp_max(cap / torch.clamp_min(v_norm, 1e-8), 1.0)
    vx, vy = vx * scale, vy * scale

    # time-optimal rotate (see pass_endurance_expert)
    mag = torch.minimum(
        torch.sqrt(2.0 * brake * torch.abs(head_err)), 30.0 * torch.abs(head_err)
    )
    w_des = torch.sign(head_err) * torch.clamp_max(mag, w_max)

    # ---- 4. kick gate on the actual heading: the predicted goal-line
    # crossing inside the mouth with a post margin, and the heading ray
    # clear of every defender by more than a robot + ball radius
    hx, hy = torch.cos(theta), torch.sin(theta)
    reach = (half_len - bx) / torch.clamp_min(hx, 0.05)
    y_pred = by + hy * reach
    on_target = (hx > 0.2) & (torch.abs(y_pred) < half_goal - 0.06)
    t_ray = torch.minimum(
        torch.clamp_min((dx - bx) * hx + (dy - by) * hy, 0.0), torch.clamp_min(reach, 0.0)
    )
    ray_clear = torch.hypot(dx - (bx + t_ray * hx), dy - (by + t_ray * hy)).amin(0)
    kick = has_ball & on_target & (torch.abs(w) < w_tol) & (ray_clear > 0.16)

    action = torch.stack([
        vx / 2.5, vy / 2.5, w_des / 10.0,
        # +-1, not {0, 1}: the env's kick gate is a3 > 0, and a symmetric
        # target keeps an MSE-cloned head on the right side of it
        torch.where(kick, 1.0, -1.0), torch.ones_like(vx),
    ])
    gates = {
        "behind_near": 0.12 - d_pre, "behind_along": -0.05 - along,
        "gk_band": band_hi - torch.abs(ry), "deep": rx - gk_limit,
        "margin_y": torch.abs(ry) - (half_wid - 0.15),
        "kick_hx": hx - 0.2, "kick_mouth": (half_goal - 0.06) - torch.abs(y_pred),
        "kick_w": w_tol - torch.abs(w), "kick_ray": ray_clear - 0.16,
        "aim_seam": _seam(err), "fetch_seam": _seam(fetch_err),
    }
    return torch.clamp(action, -1.0, 1.0), gates


def static_defenders_expert(state, field, kp=3.0, kw=5.0, w_max=6.0, fetch_speed=1.5,
                            carry_speed=0.7, avoid_radius=0.45, avoid_gain=3.0, brake=40.0,
                            w_tol=0.5, n_targets=9):
    """Scripted SSLStaticDefenders policy: state -> action (5, B) in [-1, 1].

    1. Shot selection: ``n_targets`` aims across the goal mouth, each
       lane's clearance from every defender, a clearance softmax.
    2. Fetch (no ball): face-point control onto a pre-point behind the
       ball along the shot line, then onto the ball; dribbler on.
    3. Carry/aim (infrared): rotate onto the shot line with the
       time-optimal braking profile, push goalward while aligned, with
       defender repulsion.
    4. Kick gated on the actual release heading.
    5. Safety clamps: never into the GK area or out of the field.

    ``field`` is the env's FieldParams.
    """
    return _static_defenders(state, field, kp, kw, w_max, fetch_speed, carry_speed,
                             avoid_radius, avoid_gain, brake, w_tol, n_targets)[0]


def _pass_endurance(state, brake=40.0, w_max=6.0, base_tol=0.015, w_tol=0.3, lead=0.0125):
    rb = state.world.robots
    sx, sy, theta, w = rb.x[0], rb.y[0], rb.theta[0], rb.v_theta[0]
    rx, ry = rb.x[1], rb.y[1]

    dist = torch.hypot(rx - sx, ry - sy)
    aim = torch.atan2(ry - sy, rx - sx)
    err = _wrap(aim - theta)

    # braking profile far out, proportional (non-oscillating) near zero
    mag = torch.minimum(torch.sqrt(2.0 * brake * torch.abs(err)), 30.0 * torch.abs(err))
    w_des = torch.sign(err) * torch.clamp_max(mag, w_max)

    tol = torch.clamp(base_tol / torch.clamp_min(dist, 0.25), 0.006, 0.05)
    seated = rb.infrared[0]  # the ball actually on the face
    aim_off = torch.abs(err - w * lead)
    ready = (aim_off < tol) & (torch.abs(w) < w_tol) & seated

    action = torch.stack([w_des / 10.0, torch.where(ready, 1.0, 0.0), torch.ones_like(w_des)])
    gates = {"ready_aim": tol - aim_off, "ready_w": w_tol - torch.abs(w), "aim_seam": _seam(err)}
    return action, gates


def pass_endurance_expert(state, brake=40.0, w_max=6.0, base_tol=0.015,
                          w_tol=0.3, lead=0.0125):
    """Scripted SSLPassEndurance policy: state -> action (3, B).

    The shooter cannot translate: aim time-optimally (the braking profile
    ``w = sqrt(2 * brake * |err|)``, proportional near zero) and kick when
    the heading, led by ``lead`` seconds of the current angular rate, is
    within a distance-scaled tolerance, the rotation is slow and the ball
    sits on the face (``infrared``)."""
    return _pass_endurance(state, brake, w_max, base_tol, w_tol, lead)[0]


# env id -> expert factory (the SD expert needs the env's field geometry)
EXPERTS = {
    "SSLDribbling-v0": lambda env: dribbling_expert,
    "SSLPassEndurance-v0": lambda env: pass_endurance_expert,
    "SSLStaticDefenders-v0": lambda env: (
        lambda state: static_defenders_expert(state, field=env.field)
    ),
}
