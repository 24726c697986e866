"""SSL omnidirectional world step on batch-last tensors.

Port of ``rsoccer_tpu/physics/ssl.py``: per robot either four wheel-speed
targets (mapped to a local body velocity through the f32 pseudo-inverse of
the wheel jacobian) or a local-frame velocity target, tracked under
acceleration clamps; robot-robot contacts; the ball's rolling friction,
dribbler pull toward the kicker face, vertical axis, ball-robot contacts
(a dribbling robot's kicker face absorbs with ``rest_dribbler``, chosen on
the pre-resolve ball position) and the kick, ``n_substeps`` times per
control step.  SSL fields have no walls in play.  Reports infrared (ball on
the kicker face) and the achieved wheel speeds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.core.field import FieldParams
from benchmark.reference.core.state import (
    BallState, RobotsState, SSLCommands, WorldState,
)
from benchmark.reference.physics import common
from benchmark.reference.physics.config import PhysicsConfig


def wheel_jacobian(field: FieldParams) -> np.ndarray:
    """(4, 3) float32 map from local (vx, vy, w) to wheel surface speeds
    (m/s): wheel i at angle phi_i from the heading rolls at
    -sin(phi) vx + cos(phi) vy + R w."""
    phis = [math.radians(a) for a in (
        field.rbt_wheel0_angle, field.rbt_wheel1_angle,
        field.rbt_wheel2_angle, field.rbt_wheel3_angle,
    )]
    return np.asarray(
        [[-math.sin(p), math.cos(p), field.rbt_radius] for p in phis],
        dtype=np.float32,
    )


def achieved_wheel_speeds(v_x, v_y, cos_t, sin_t, v_theta, J: np.ndarray,
                          wheel_radius: float):
    """Forward jacobian of the body velocity -> (N, 4, B) wheel rad/s."""
    u = v_x * cos_t + v_y * sin_t
    s = -v_x * sin_t + v_y * cos_t
    return torch.stack(
        [(float(J[k, 0]) * u + float(J[k, 1]) * s + float(J[k, 2]) * v_theta)
         / wheel_radius for k in range(4)],
        dim=1,
    )


def make_face_zone(field: FieldParams, cfg: PhysicsConfig):
    """``face_zone(x, y, cos_t, sin_t, bx, by, bz, reach=0.0)``: the ball
    centre inside robot's kicker-face window (extended by ``reach`` along
    the heading) and low enough for the kicker plate.  With ``reach=0`` it
    is the infrared / kick predicate; with ``dribbler_reach`` the
    dribbler's pull zone."""
    contact_lo = (field.rbt_distance_center_kicker - field.rbt_kicker_thickness
                  - field.ball_radius)
    contact_hi = (field.rbt_distance_center_kicker + field.ball_radius
                  + cfg.kicker_depth_slack)
    half_kick_w = field.rbt_kicker_width / 2

    def face_zone(x, y, cos_t, sin_t, bx, by, bz, reach: float = 0.0):
        dx = bx - x
        dy = by - y
        lx = dx * cos_t + dy * sin_t  # along the heading
        ly = -dx * sin_t + dy * cos_t  # lateral
        low = (bz - field.ball_radius) <= cfg.kicker_height
        return ((lx >= contact_lo) & (lx <= contact_hi + reach)
                & (torch.abs(ly) <= half_kick_w) & low)

    return face_zone


def make_ssl_step(field: FieldParams, cfg: PhysicsConfig, dt: float):
    """Build ``step(world, commands) -> world`` with all constants folded."""
    dts = dt / cfg.n_substeps
    a_lin = cfg.robot_accel * dts
    a_ang = cfg.robot_alpha * dts
    max_wheel = field.max_wheel_rad_s
    wheel_r = field.rbt_wheel_radius
    J = wheel_jacobian(field)
    J_pinv = np.linalg.pinv(J)  # (3, 4) float32, least squares
    face_dist = field.rbt_distance_center_kicker
    face_zone = make_face_zone(field, cfg)

    def local_targets(commands: SSLCommands):
        """(tu, tv, tw) local velocity targets, each (N, B)."""
        wheel_ms = torch.clamp(commands.v_wheel, -max_wheel, max_wheel) * wheel_r
        jp = torch.from_numpy(J_pinv).to(wheel_ms.device, wheel_ms.dtype)
        from_wheels = torch.einsum("nkb,ck->ncb", wheel_ms, jp)
        ws = commands.wheel_speed
        return tuple(
            torch.where(ws, from_wheels[:, c], direct)
            for c, direct in enumerate(
                (commands.v_x, commands.v_y, commands.v_theta))
        )

    def substep(world: WorldState, tgt, commands: SSLCommands):
        rb, ball = world.robots, world.ball
        tu, tv, tw = tgt
        cos_t = torch.cos(rb.theta)
        sin_t = torch.sin(rb.theta)

        # drive: track the local-frame target under accel clamps
        u = rb.v_x * cos_t + rb.v_y * sin_t
        s = -rb.v_x * sin_t + rb.v_y * cos_t
        u = u + torch.clamp(tu - u, -a_lin, a_lin)
        s = s + torch.clamp(tv - s, -a_lin, a_lin)
        w = rb.v_theta + torch.clamp(tw - rb.v_theta, -a_ang, a_ang)
        theta = common.wrap_angle(rb.theta + w * dts)
        cos_n = torch.cos(theta)
        sin_n = torch.sin(theta)
        v_x = u * cos_n - s * sin_n
        v_y = u * sin_n + s * cos_n
        x = rb.x + v_x * dts
        y = rb.y + v_y * dts
        x, y, v_x, v_y = common.resolve_robot_robot(
            x, y, v_x, v_y, field.rbt_radius, cfg.rest_robot_robot
        )

        # ball: friction (grounded only), dribbler pull, vertical, integrate
        on_ground = common.ball_on_ground(ball.z, field.ball_radius)
        fvx, fvy = common.apply_ball_friction(
            ball.v_x, ball.v_y, cfg.ball_friction_decel, dts
        )
        bvx = torch.where(on_ground, fvx, ball.v_x)
        bvy = torch.where(on_ground, fvy, ball.v_y)

        held = face_zone(x, y, cos_n, sin_n, ball.x, ball.y, ball.z,
                         cfg.dribbler_reach) & commands.dribbler
        # spring-damper toward each holding robot's face point; damping
        # against the face point's velocity (incl. omega x r)
        face_x = x + face_dist * cos_n
        face_y = y + face_dist * sin_n
        rel_vx = bvx - (v_x - w * face_dist * sin_n)
        rel_vy = bvy - (v_y + w * face_dist * cos_n)
        rel_speed = torch.sqrt(rel_vx * rel_vx + rel_vy * rel_vy)
        can_hold = held & (rel_speed < cfg.dribbler_capture_speed)
        pull_x = torch.where(
            can_hold,
            cfg.dribbler_pull_accel * (face_x - ball.x) - cfg.dribbler_damping * rel_vx,
            0.0,
        ).sum(0)
        pull_y = torch.where(
            can_hold,
            cfg.dribbler_pull_accel * (face_y - ball.y) - cfg.dribbler_damping * rel_vy,
            0.0,
        ).sum(0)
        bvx = bvx + pull_x * dts
        bvy = bvy + pull_y * dts

        bz, bvz = common.step_ball_vertical(
            ball.z, ball.v_z, field.ball_radius,
            cfg.gravity, cfg.rest_ball_ground, cfg.ball_bounce_min_v, dts,
        )
        bx = ball.x + bvx * dts
        by = ball.y + bvy * dts
        below_top = (bz - field.ball_radius) < cfg.rbt_height
        # the kicker face of a dribbling robot absorbs the ball (pre-resolve
        # ball position)
        face_in = face_zone(x, y, cos_n, sin_n, bx, by, bz)
        rest = torch.where(face_in & commands.dribbler,
                           cfg.rest_dribbler, cfg.rest_ball_robot)
        bx, by, bvx, bvy = common.resolve_ball_robots(
            bx, by, bvx, bvy, x, y, v_x, v_y,
            field.rbt_radius, field.ball_radius, rest, active=below_top,
        )

        # kick: replace the ball velocity along the heading; a positive
        # kick_v_z launches it (chip kick)
        contact_after = face_zone(x, y, cos_n, sin_n, bx, by, bz)
        kicking = contact_after & (commands.kick_v_x > 0.0)
        kvx = torch.where(kicking, commands.kick_v_x * cos_n, 0.0).sum(0)
        kvy = torch.where(kicking, commands.kick_v_x * sin_n, 0.0).sum(0)
        kvz = torch.where(kicking, commands.kick_v_z, 0.0).sum(0)
        any_kick = kicking.any(0)
        bvx = torch.where(any_kick, kvx, bvx)
        bvy = torch.where(any_kick, kvy, bvy)
        bvz = torch.where(any_kick & (kvz > 0.0), kvz, bvz)

        world = WorldState(
            ball=BallState(x=bx, y=by, z=bz, v_x=bvx, v_y=bvy, v_z=bvz),
            robots=RobotsState(
                x=x, y=y, theta=theta, v_x=v_x, v_y=v_y, v_theta=w,
                infrared=contact_after, v_wheel=rb.v_wheel,
            ),
        )
        return world, (cos_n, sin_n)

    def step(world: WorldState, commands: SSLCommands) -> WorldState:
        tgt = local_targets(commands)
        for _ in range(cfg.n_substeps):
            world, (cos_t, sin_t) = substep(world, tgt, commands)
        rb = world.robots
        v_wheel = achieved_wheel_speeds(rb.v_x, rb.v_y, cos_t, sin_t,
                                        rb.v_theta, J, wheel_r)
        return world._replace(robots=rb._replace(v_wheel=v_wheel))

    return step
