"""Shared machinery for the SSL hardware-challenge tasks.

Port of ``rsoccer_tpu/envs/ssl_common.py`` on batch-last tensors: the
task speed caps, the global->local action conversion with its
scale-only-above-max clip, single-robot commands, the shared observation
block and the distance-based shaping rewards.

Units: radians internally; the obs divides ``v_theta`` by deg2rad(10), which
reproduces the reference's observed values (it divides deg/s by 10).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.core.field import ssl_field
from benchmark.reference.core.state import BallState, RobotsState, WorldState, zero_ssl_commands
from benchmark.reference.envs.base import Env
from benchmark.reference.physics.config import SSL_PHYSICS
from benchmark.reference.physics.ssl import make_ssl_step

_EPS = 1e-8


def termination_chain(f, rx, ry, bx, by):
    """The reference's termination priority chain of StaticDefenders and
    ContestedPossession (static_defenders.py:179-197):
    (c_rbt_out, c_gk, c_ball_out, goal, ball_out_right, chain_done)."""
    half_len, half_wid = f.half_length, f.half_width
    pen_len, half_pen_wid = f.penalty_length, f.penalty_width / 2
    c_rbt_out = (rx < -0.2) | (torch.abs(ry) > half_wid)
    c_gk = ~c_rbt_out & (rx > half_len - pen_len) & (torch.abs(ry) < half_pen_wid)
    c_ball_out = ~c_rbt_out & ~c_gk & ((bx < 0) | (torch.abs(by) > half_wid))
    c_ball_right = ~c_rbt_out & ~c_gk & ~c_ball_out & (bx > half_len)
    goal = c_ball_right & (torch.abs(by) < f.goal_width / 2)
    ball_out_right = c_ball_right & ~goal
    chain_done = c_rbt_out | c_gk | c_ball_out | c_ball_right
    return c_rbt_out, c_gk, c_ball_out, goal, ball_out_right, chain_done


class SSLTaskBase(Env):
    """Common constants and helpers of the SSL tasks."""

    league = "ssl"

    # task caps (reference static_defenders.py:76-78 etc.)
    max_v = 2.5  # m/s
    max_w_cmd = 10.0  # rad/s command scale
    max_w_norm = math.radians(10.0)  # obs normaliser
    kick_speed_x = 5.0
    norm_bounds = 1.2

    def __init__(self, field_type: int, n_blue: int, n_yellow: int, time_step: float):
        self.field = ssl_field(field_type)
        self.n_blue = n_blue
        self.n_yellow = n_yellow
        self.n_robots = n_blue + n_yellow
        self.time_step = time_step
        self.max_pos = self.field.max_pos
        self.physics_cfg = SSL_PHYSICS
        self._physics = make_ssl_step(self.field, SSL_PHYSICS, time_step)

    def _norm_pos(self, v):
        return torch.clamp(v / self.max_pos, -self.norm_bounds, self.norm_bounds)

    def _norm_v(self, v):
        return torch.clamp(v / self.max_v, -self.norm_bounds, self.norm_bounds)

    def _norm_w(self, w):
        return torch.clamp(w / self.max_w_norm, -self.norm_bounds, self.norm_bounds)

    # --- actions
    def convert_actions(self, action, angle):
        """Denormalise, rotate global->local, scale the speed down only
        above ``max_v`` (reference static_defenders.py:132-148)."""
        v_x = action[0] * self.max_v
        v_y = action[1] * self.max_v
        v_theta = action[2] * self.max_w_cmd
        c, s = torch.cos(angle), torch.sin(angle)
        v_x, v_y = v_x * c + v_y * s, -v_x * s + v_y * c
        v_norm = torch.sqrt(v_x * v_x + v_y * v_y)
        scale = torch.where(
            v_norm < self.max_v, 1.0, self.max_v / torch.clamp_min(v_norm, _EPS)
        )
        return v_x * scale, v_y * scale, v_theta

    def single_robot_commands(self, v_x, v_y, v_theta, kick_v_x, dribbler):
        """Commands driving blue robot 0; every other robot idle."""
        cmd = zero_ssl_commands(self.n_robots, v_x.shape[-1], v_x.device)

        def row0(zeros, v):
            return torch.cat([v[None].to(zeros.dtype), zeros[1:]])

        return cmd._replace(
            v_x=row0(cmd.v_x, v_x), v_y=row0(cmd.v_y, v_y),
            v_theta=row0(cmd.v_theta, v_theta),
            kick_v_x=row0(cmd.kick_v_x, kick_v_x),
            dribbler=row0(cmd.dribbler, dribbler),
        )

    def task_commands(self, state, action):
        """The five-slot action of SD and CP -> commands for robot 0."""
        v_x, v_y, v_theta = self.convert_actions(action, state.world.robots.theta[0])
        return self.single_robot_commands(
            v_x, v_y, v_theta,
            kick_v_x=torch.where(action[3] > 0, self.kick_speed_x, 0.0),
            dribbler=action[4] > 0,
        )

    # --- observation
    def observe_standard(self, world: WorldState, infrared_low: float = 0.0):
        """Ball (4) + per blue (x, y, sin, cos, vx, vy, w, infrared) + per
        yellow (x, y) — the layout of StaticDefenders, Dribbling and
        ContestedPossession (static_defenders.py:90-112) -> (obs, B)."""
        b, rb, nb = world.ball, world.robots, self.n_blue
        rows = [self._norm_pos(b.x), self._norm_pos(b.y),
                self._norm_v(b.v_x), self._norm_v(b.v_y)]
        for i in range(nb):
            rows += [
                self._norm_pos(rb.x[i]), self._norm_pos(rb.y[i]),
                torch.sin(rb.theta[i]), torch.cos(rb.theta[i]),
                self._norm_v(rb.v_x[i]), self._norm_v(rb.v_y[i]),
                self._norm_w(rb.v_theta[i]),
                torch.where(rb.infrared[i], 1.0, infrared_low),
            ]
        for i in range(nb, self.n_robots):
            rows += [self._norm_pos(rb.x[i]), self._norm_pos(rb.y[i])]
        return torch.stack(rows)

    # --- shaping rewards
    @staticmethod
    def dist(ax, ay, bx, by):
        return torch.sqrt((ax - bx) ** 2 + (ay - by) ** 2)

    def ball_dist_rw(self, world, last_world):
        """Robot-0-to-ball distance delta, clipped (static_defenders.py:256-282)."""
        last_d = self.dist(last_world.robots.x[0], last_world.robots.y[0],
                           last_world.ball.x, last_world.ball.y)
        d = self.dist(world.robots.x[0], world.robots.y[0], world.ball.x, world.ball.y)
        return torch.clamp(last_d - d, -1.0, 1.0)

    def ball_grad_rw(self, world, last_world):
        """Ball-to-goal distance delta, clipped (static_defenders.py:284-309)."""
        gx = self.field.half_length
        last_d = self.dist(last_world.ball.x, last_world.ball.y, gx, 0.0)
        d = self.dist(world.ball.x, world.ball.y, gx, 0.0)
        return torch.clamp(last_d - d, -1.0, 1.0)

    def energy_pen(self, world):
        """Sum |achieved wheel speed| of robot 0 after the step."""
        return torch.abs(world.robots.v_wheel[0]).sum(0)

    def make_world(self, ball_x, ball_y, rx, ry, rtheta) -> WorldState:
        """A resting world: ball (B,) on the ground, robots (N, B)."""
        z = torch.zeros_like(ball_x)
        zn = torch.zeros_like(rx)
        return WorldState(
            ball=BallState(x=ball_x, y=ball_y, z=torch.full_like(z, self.field.ball_radius),
                           v_x=z, v_y=z, v_z=z),
            robots=RobotsState(
                x=rx, y=ry, theta=rtheta, v_x=zn, v_y=zn, v_theta=zn,
                infrared=torch.zeros_like(rx, dtype=torch.bool),
                v_wheel=torch.zeros((rx.shape[0], 4) + z.shape, device=z.device),
            ),
        )
