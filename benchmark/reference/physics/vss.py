"""VSS differential-drive world step on batch-last tensors.

Port of ``rsoccer_tpu/physics/vss.py``: commanded wheel speeds map to a
target forward/angular velocity; the body tracks it under acceleration
clamps while lateral slip decays; then robot-robot, robot-wall, ball and
ball-robot/wall contacts, ``n_substeps`` times per control step.

The coefficients of ``cfg`` may be 0-d tensors, as the JAX step's may be
traced values: ``tools/calibrate.py`` differentiates the step with
respect to them.  With float coefficients the constants fold in double
precision as before, so the float path keeps its bits.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.core.field import FieldParams
from benchmark.reference.core.state import (
    BallState, RobotsState, VSSCommands, WorldState,
)
from benchmark.reference.physics import common
from benchmark.reference.physics.config import PhysicsConfig

HALF_AXLE = 0.04  # m — reference vss/vss_gym_base.py:57-58


def achieved_wheel_speeds(v_x, v_y, theta, v_theta, wheel_radius: float):
    """Forward kinematics of the body velocity -> (N, 4, B) wheel speeds
    (two driven wheels, two zero slots for the SSL-shaped channel)."""
    u = v_x * torch.cos(theta) + v_y * torch.sin(theta)
    w0 = (u - v_theta * HALF_AXLE) / wheel_radius
    w1 = (u + v_theta * HALF_AXLE) / wheel_radius
    z = torch.zeros_like(w0)
    return torch.stack([w0, w1, z, z], dim=1)


def make_vss_step(field: FieldParams, cfg: PhysicsConfig, dt: float):
    """Build ``step(world, commands) -> world`` with all constants folded."""
    dts = dt / cfg.n_substeps
    if isinstance(cfg.lateral_decay, torch.Tensor):
        lat_keep = torch.exp(-cfg.lateral_decay * dts)
    else:  # folded in double, as the kernels' plain versions expect
        lat_keep = math.exp(-cfg.lateral_decay * dts)
    max_wheel = field.max_wheel_rad_s
    wheel_r = field.rbt_wheel_radius
    a_lin = cfg.robot_accel * dts
    a_ang = cfg.robot_alpha * dts

    def substep(world: WorldState, v_tgt, w_tgt) -> WorldState:
        rb = world.robots
        ball = world.ball

        # --- robot drive: track (forward, angular) targets under accel clamp
        cos_t = torch.cos(rb.theta)
        sin_t = torch.sin(rb.theta)
        u = rb.v_x * cos_t + rb.v_y * sin_t  # forward speed
        s = -rb.v_x * sin_t + rb.v_y * cos_t  # lateral slip
        u = u + common.clip(v_tgt - u, -a_lin, a_lin)
        s = s * lat_keep
        w = rb.v_theta + common.clip(w_tgt - rb.v_theta, -a_ang, a_ang)

        theta = common.wrap_angle(rb.theta + w * dts)
        cos_n = torch.cos(theta)
        sin_n = torch.sin(theta)
        v_x = u * cos_n - s * sin_n
        v_y = u * sin_n + s * cos_n
        x = rb.x + v_x * dts
        y = rb.y + v_y * dts

        # --- collisions
        x, y, v_x, v_y = common.resolve_robot_robot(
            x, y, v_x, v_y, field.rbt_radius, cfg.rest_robot_robot
        )
        x, y, v_x, v_y = common.clamp_robots_walls_vss(
            x, y, v_x, v_y, field.half_length, field.half_width,
            field.rbt_radius,
        )

        # --- ball: rolling friction only while grounded, vertical axis
        on_ground = common.ball_on_ground(ball.z, field.ball_radius)
        fvx, fvy = common.apply_ball_friction(
            ball.v_x, ball.v_y, cfg.ball_friction_decel, dts
        )
        bvx = torch.where(on_ground, fvx, ball.v_x)
        bvy = torch.where(on_ground, fvy, ball.v_y)
        bz, bvz = common.step_ball_vertical(
            ball.z, ball.v_z, field.ball_radius,
            cfg.gravity, cfg.rest_ball_ground, cfg.ball_bounce_min_v, dts,
        )
        bx = ball.x + bvx * dts
        by = ball.y + bvy * dts
        below_top = (bz - field.ball_radius) < cfg.rbt_height
        bx, by, bvx, bvy = common.resolve_ball_robots(
            bx, by, bvx, bvy, x, y, v_x, v_y,
            field.rbt_radius, field.ball_radius, cfg.rest_ball_robot,
            active=below_top,
        )
        bx, by, bvx, bvy = common.reflect_ball_walls_vss(
            bx, by, bvx, bvy,
            field.half_length, field.half_width,
            field.goal_width / 2, field.goal_depth,
            field.ball_radius, cfg.rest_ball_wall,
        )
        return WorldState(
            ball=BallState(x=bx, y=by, z=bz, v_x=bvx, v_y=bvy, v_z=bvz),
            robots=RobotsState(
                x=x, y=y, theta=theta, v_x=v_x, v_y=v_y, v_theta=w,
                infrared=rb.infrared, v_wheel=rb.v_wheel,
            ),
        )

    def step(world: WorldState, commands: VSSCommands) -> WorldState:
        wl = common.clip(commands.v_wheel0, -max_wheel, max_wheel)
        wr = common.clip(commands.v_wheel1, -max_wheel, max_wheel)
        v_tgt = wheel_r * (wl + wr) / 2.0
        w_tgt = wheel_r * (wr - wl) / (2.0 * HALF_AXLE)
        for _ in range(cfg.n_substeps):
            world = substep(world, v_tgt, w_tgt)
        rb = world.robots
        v_wheel = achieved_wheel_speeds(
            rb.v_x, rb.v_y, rb.theta, rb.v_theta, wheel_r
        )
        return world._replace(robots=rb._replace(v_wheel=v_wheel))

    return step
