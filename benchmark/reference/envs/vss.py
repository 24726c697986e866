"""VSS-v0: 3v3 differential-drive match, agent controls blue robot 0.

Port of ``rsoccer_tpu/envs/vss.py`` (reference vss/env_vss/vss_gym.py) on
batch-last tensors:

  - Obs Box(40): ball [x,y,vx,vy] + 3 blues x [x,y,sin,cos,vx,vy,vtheta] +
    3 yellows x [x,y,vx,vy,vtheta], normalised and clipped to +-1.2.
  - Action Box(2): wheel-speed fractions; scaled by max_v, clipped, 0.05 m/s
    deadzone, divided by the wheel radius.
  - The other 5 robots are driven by Ornstein-Uhlenbeck noise.
  - Reward: goal +-10 terminal, else 0.2*move + 0.8*ball_grad + 2e-4*energy.
  - Reset: uniform spawns with 0.1 m separation; 1200-step TimeLimit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.core.field import vss_field
from benchmark.reference.core.state import (
    BallState, RobotsState, VSSCommands, WorldState,
)
from benchmark.reference.envs import ou, spawn
from benchmark.reference.envs.base import Env
from benchmark.reference.physics.config import VSS_PHYSICS
from benchmark.reference.physics.vss import HALF_AXLE, make_vss_step

_SHAPING_KEYS = (
    "goal_score",
    "move",
    "ball_grad",
    "energy",
    "goals_blue",
    "goals_yellow",
)


class VSSState(NamedTuple):
    world: WorldState
    steps: torch.Tensor  # (B,) int32
    ou_x: torch.Tensor  # (N, 2, B) OU process state, robot 0 unused (agent)
    ball_potential: torch.Tensor  # (B,) previous potential
    has_potential: torch.Tensor  # (B,) bool — False right after reset
    shaping: torch.Tensor  # (6, B) accumulators, order _SHAPING_KEYS


class VSSEnv(Env):
    """VSS-v0 (reference vss/env_vss/vss_gym.py:13-311)."""

    obs_size = 40
    action_size = 2
    max_episode_steps = 1200  # reference rsoccer_gym/__init__.py:4
    league = "vss"

    def __init__(
        self,
        field_type: int = 0,
        n_robots_blue: int = 3,
        n_robots_yellow: int = 3,
        time_step: float = 0.025,
    ):
        self.field = vss_field(field_type)
        self.n_blue = n_robots_blue
        self.n_yellow = n_robots_yellow
        self.n_robots = n_robots_blue + n_robots_yellow
        self.time_step = time_step
        self.obs_size = 4 + 7 * n_robots_blue + 5 * n_robots_yellow

        f = self.field
        self.max_pos = f.max_pos
        self.max_v = f.max_v
        self.max_w_rad = self.max_v / HALF_AXLE  # rad/s
        self.norm_bounds = 1.2  # reference vss_gym_base.py:26
        self.v_wheel_deadzone = 0.05  # reference vss_gym.py:73

        self.physics_cfg = VSS_PHYSICS
        self._physics = make_vss_step(f, VSS_PHYSICS, time_step)

    # ------------------------------------------------------------------ obs
    def _norm_pos(self, v):
        return torch.clamp(v / self.max_pos, -self.norm_bounds, self.norm_bounds)

    def _norm_v(self, v):
        return torch.clamp(v / self.max_v, -self.norm_bounds, self.norm_bounds)

    def _norm_w(self, w):
        return torch.clamp(w / self.max_w_rad, -self.norm_bounds, self.norm_bounds)

    def observe(self, state) -> torch.Tensor:
        """Reference obs layout vss_gym.py:93-117 -> (obs_size, B)."""
        b = state.world.ball
        rb = state.world.robots
        rows = [
            self._norm_pos(b.x), self._norm_pos(b.y),
            self._norm_v(b.v_x), self._norm_v(b.v_y),
        ]
        for i in range(self.n_blue):
            rows += [
                self._norm_pos(rb.x[i]), self._norm_pos(rb.y[i]),
                torch.sin(rb.theta[i]), torch.cos(rb.theta[i]),
                self._norm_v(rb.v_x[i]), self._norm_v(rb.v_y[i]),
                self._norm_w(rb.v_theta[i]),
            ]
        for i in range(self.n_blue, self.n_robots):
            rows += [
                self._norm_pos(rb.x[i]), self._norm_pos(rb.y[i]),
                self._norm_v(rb.v_x[i]), self._norm_v(rb.v_y[i]),
                self._norm_w(rb.v_theta[i]),
            ]
        return torch.stack(rows)

    # -------------------------------------------------------------- actions
    def _actions_to_wheels(self, actions):
        """Reference vss_gym.py:235-254.  actions (N, 2, B) fractions ->
        (left, right) wheel rad/s, each (N, B)."""
        v = torch.clamp(actions * self.max_v, -self.max_v, self.max_v)
        v = torch.where(torch.abs(v) < self.v_wheel_deadzone, 0.0, v)
        w = v / self.field.rbt_wheel_radius
        return w[:, 0], w[:, 1]

    # ---------------------------------------------------------------- noise
    def transition_noise_spec(self):
        return {"ou": ((self.n_robots, 2), "normal")}

    def reset_noise_spec(self):
        return {
            "spawn": ((1 + self.n_robots, 2, spawn.N_CANDIDATES), "uniform"),
            "theta": ((self.n_robots,), "uniform"),
        }

    # ---------------------------------------------------------------- reset
    def reset_state(self, noise):
        f = self.field
        xs, ys = spawn.place_separated(
            noise["spawn"],
            x_lo=-f.half_length + 0.1,
            x_hi=f.half_length - 0.1,
            y_lo=-f.half_width + 0.1,
            y_hi=f.half_width - 0.1,
            min_dist=0.1,  # reference vss_gym.py:212
        )
        thetas = spawn.angles_from_uniform(noise["theta"])
        n = self.n_robots
        z = torch.zeros_like(xs[0])
        zn = torch.zeros_like(thetas)
        world = WorldState(
            ball=BallState(
                x=xs[0], y=ys[0], z=torch.full_like(z, f.ball_radius),
                v_x=z, v_y=z, v_z=z,
            ),
            robots=RobotsState(
                x=xs[1:], y=ys[1:], theta=thetas,
                v_x=zn, v_y=zn, v_theta=zn,
                infrared=torch.zeros_like(zn, dtype=torch.bool),
                v_wheel=torch.zeros((n, 4) + z.shape, device=z.device),
            ),
        )
        return VSSState(
            world=world,
            steps=torch.zeros_like(z, dtype=torch.int32),
            ou_x=torch.zeros((n, 2) + z.shape, device=z.device),
            ball_potential=z,
            has_potential=torch.zeros_like(z, dtype=torch.bool),
            shaping=torch.zeros((len(_SHAPING_KEYS),) + z.shape, device=z.device),
        )

    # ----------------------------------------------------------------- step
    def pre_physics(self, state: VSSState, action, noise):
        """Commands from state + action (2, B) + noise (reference
        vss_gym.py:119-142; OU row 0 exists but the agent overrides it)."""
        ou_x = ou.ou_update(state.ou_x, noise["ou"], self.time_step)
        all_actions = torch.cat([action[None], ou_x[1:]], dim=0)
        wl, wr = self._actions_to_wheels(all_actions)
        return VSSCommands(v_wheel0=wl, v_wheel1=wr), (ou_x, wl, wr)

    def transition(self, state: VSSState, action, noise):
        commands, aux = self.pre_physics(state, action, noise)
        world = self._physics(state.world, commands)
        return self.post_physics(state, world, aux)

    def post_physics(self, state: VSSState, world, aux):
        f = self.field
        ou_x, wl, wr = aux

        # --- reward & done (reference vss_gym.py:144-192)
        b = world.ball
        goal_blue = b.x > f.half_length
        goal_yellow = b.x < -f.half_length
        goal = goal_blue | goal_yellow

        # ball potential (reference vss_gym.py:256-283)
        half_l = f.half_length + f.goal_depth
        dx_d = (half_l + b.x) * 100.0
        dx_a = (half_l - b.x) * 100.0
        dy = b.y * 100.0
        dist_1 = -torch.sqrt(dx_a * dx_a + 2.0 * dy * dy)
        dist_2 = torch.sqrt(dx_d * dx_d + 2.0 * dy * dy)
        potential = ((dist_1 + dist_2) / (f.length * 100.0) - 1.0) / 2.0
        grad = torch.where(
            state.has_potential,
            torch.clamp(
                (potential - state.ball_potential) * 3.0 / self.time_step,
                -5.0, 5.0,
            ),
            0.0,
        )

        # move-to-ball (reference vss_gym.py:285-303)
        r0x, r0y = world.robots.x[0], world.robots.y[0]
        rbx, rby = b.x - r0x, b.y - r0y
        rb_norm = torch.clamp_min(torch.sqrt(rbx * rbx + rby * rby), 1e-8)
        rbx, rby = rbx / rb_norm, rby / rb_norm
        move = rbx * world.robots.v_x[0] + rby * world.robots.v_y[0]
        move = torch.clamp(move / 0.4, -5.0, 5.0)

        # energy penalty on the agent's sent wheel commands (vss_gym.py:305-311)
        energy = -(torch.abs(wl[0]) + torch.abs(wr[0]))

        w_move, w_grad, w_energy = 0.2, 0.8, 2e-4  # vss_gym.py:147-149
        shaped = w_move * move + w_grad * grad + w_energy * energy
        reward = torch.where(
            goal_blue, 10.0, torch.where(goal_yellow, -10.0, shaped)
        )

        zero = torch.zeros_like(shaped)
        on_goal = torch.stack([
            torch.where(goal_blue, 1.0, -1.0), zero, zero, zero,
            goal_blue.to(shaped.dtype), goal_yellow.to(shaped.dtype),
        ])
        on_play = torch.stack([
            zero, w_move * move, w_grad * grad, w_energy * energy, zero, zero,
        ])
        shaping = state.shaping + torch.where(goal, on_goal, on_play)

        ns = VSSState(
            world=world,
            steps=state.steps + 1,
            ou_x=ou_x,
            ball_potential=potential,
            has_potential=torch.ones_like(state.has_potential),
            shaping=shaping,
        )
        info = {k: shaping[i] for i, k in enumerate(_SHAPING_KEYS)}
        return ns, reward, goal, info
