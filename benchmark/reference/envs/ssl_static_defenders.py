"""SSLStaticDefenders-v0: 1 blue shooter vs 6 static yellow defenders.

Port of ``rsoccer_tpu/envs/ssl_static_defenders.py`` (reference
ssl/ssl_hw_challenge/static_defenders.py) on batch-last tensors:

  - Obs Box(24): ball 4 + blue 8 (incl. infrared in {0,1}) + 6 yellows x 2.
  - Action Box(5): global vx, vy, vtheta, kick, dribbler fractions.
  - Reward: goal +5 terminal; otherwise ball_dist + ball_grad + energy.
  - Termination chain: robot out > robot in the GK area > ball out
    left/side > ball past the right end line (goal iff |y| < goal/2).
  - Reset: blue at the origin, theta 0; ball uniform on the attack half
    outside the GK area; 6 yellows 0.2 m from the ball, the blue and each
    other.  1000-step TimeLimit, field_type 2.

``curriculum`` and ``terminal_penalty`` are the JAX package's training-time
extensions (see its docstring); the fused step refuses them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.core.state import WorldState
from benchmark.reference.envs import spawn
from benchmark.reference.envs.ssl_common import SSLTaskBase, termination_chain

_SHAPING_KEYS = (
    "goal",
    "rbt_in_gk_area",
    "done_ball_out",
    "done_ball_out_right",
    "done_rbt_out",
    "ball_dist",
    "ball_grad",
    "energy",
)


class SDState(NamedTuple):
    world: WorldState
    steps: torch.Tensor  # (B,) int32
    shaping: torch.Tensor  # (8, B) accumulators, order _SHAPING_KEYS


class SSLStaticDefendersEnv(SSLTaskBase):
    obs_size = 24
    action_size = 5
    max_episode_steps = 1000  # rsoccer_gym/__init__.py:11

    def __init__(self, field_type: int = 2, time_step: float = 0.025,
                 curriculum: bool = False, terminal_penalty: float = 0.0):
        super().__init__(field_type, n_blue=1, n_yellow=6, time_step=time_step)
        self.curriculum = curriculum
        self.terminal_penalty = float(terminal_penalty)
        self.obs_size = 4 + 8 * self.n_blue + 2 * self.n_yellow
        f = self.field
        # reward scales (reference static_defenders.py:64-73)
        self.ball_dist_scale = math.sqrt(f.width ** 2 + (f.length / 2) ** 2)
        self.ball_grad_scale = math.sqrt((f.width / 2) ** 2 + (f.length / 2) ** 2) / 4
        self.energy_scale = 160.0 * 4 * 1000  # wheel cap * wheels * steps

    def observe(self, state) -> torch.Tensor:
        return self.observe_standard(state.world)

    # ---------------------------------------------------------------- noise
    def reset_noise_spec(self):
        spec = {
            "ball": ((2, spawn.N_CANDIDATES), "uniform"),
            "spawn": ((self.n_yellow, 2, spawn.N_CANDIDATES), "uniform"),
            "theta": ((self.n_yellow,), "uniform"),
        }
        if self.curriculum:
            spec["cur"] = ((3,), "uniform")  # gate, radius, angle
        return spec

    # ---------------------------------------------------------------- reset
    def reset_state(self, noise):
        f = self.field
        half_len, half_wid = f.half_length, f.half_width
        pen_len, half_pen_wid = f.penalty_length, f.penalty_width / 2

        # ball: uniform on the attack half, first candidate outside the GK
        # area (reference :234-239)
        bx_c = 0.2 + noise["ball"][0] * (half_len - 0.1 - 0.2)
        by_c = -half_wid + 0.1 + noise["ball"][1] * (2 * half_wid - 0.2)
        in_gk = (bx_c > half_len - pen_len) & (torch.abs(by_c) < half_pen_wid)
        ball_x, ball_y = spawn.pick_first(~in_gk, bx_c, by_c)

        # yellows: 0.2 m from the ball, the blue (origin) and each other
        yx, yy = spawn.place_separated(
            noise["spawn"],
            x_lo=0.2, x_hi=half_len - 0.1,
            y_lo=-half_wid + 0.1, y_hi=half_wid - 0.1,
            min_dist=0.2,
            preplaced_x=[ball_x, 0.0], preplaced_y=[ball_y, 0.0],
        )

        if self.curriculum:
            # half the resets move the ball 0.21-0.50 m from defender 0,
            # keeping the original spawn where that point is illegal
            gate, r_u, phi_u = noise["cur"][0], noise["cur"][1], noise["cur"][2]
            r = 0.21 + r_u * 0.29
            phi = phi_u * (2.0 * math.pi)
            cx = torch.clamp(yx[0] + r * torch.cos(phi), 0.2, half_len - 0.1)
            cy = torch.clamp(yy[0] + r * torch.sin(phi), -half_wid + 0.1, half_wid - 0.1)
            legal = ~((cx > half_len - pen_len) & (torch.abs(cy) < half_pen_wid))
            d2_blue = cx * cx + cy * cy
            d2_others = (cx - yx[1:]) ** 2 + (cy - yy[1:]) ** 2
            clear = (d2_blue > 0.12 ** 2) & (d2_others > 0.12 ** 2).all(0)
            use = (gate < 0.5) & legal & clear
            ball_x = torch.where(use, cx, ball_x)
            ball_y = torch.where(use, cy, ball_y)

        z1 = torch.zeros_like(ball_x)[None]
        world = self.make_world(
            ball_x, ball_y,
            rx=torch.cat([z1, yx]), ry=torch.cat([z1, yy]),
            rtheta=torch.cat([z1, spawn.angles_from_uniform(noise["theta"])]),
        )
        return SDState(
            world=world,
            steps=torch.zeros_like(ball_x, dtype=torch.int32),
            shaping=torch.zeros((len(_SHAPING_KEYS),) + ball_x.shape, device=ball_x.device),
        )

    # ----------------------------------------------------------------- step
    def transition(self, state: SDState, action, noise):
        world = self._physics(state.world, self.task_commands(state, action))
        c_rbt_out, c_gk, c_ball_out, goal, ball_out_right, done = termination_chain(
            self.field, world.robots.x[0], world.robots.y[0], world.ball.x, world.ball.y
        )
        sb = ~done

        ball_dist = self.ball_dist_rw(world, state.world) / self.ball_dist_scale
        ball_grad = self.ball_grad_rw(world, state.world) / self.ball_grad_scale
        energy = -self.energy_pen(world) / self.energy_scale
        shaped = ball_dist + ball_grad + energy

        reward = torch.where(goal, 5.0, torch.where(sb, shaped, 0.0))
        if self.terminal_penalty:
            reward = reward - torch.where(done & ~goal, self.terminal_penalty, 0.0)

        zero = torch.zeros_like(reward)
        shaping = state.shaping + torch.stack([
            goal.to(zero.dtype), c_gk.to(zero.dtype), c_ball_out.to(zero.dtype),
            ball_out_right.to(zero.dtype), c_rbt_out.to(zero.dtype),
            torch.where(sb, ball_dist, zero),
            torch.where(sb, ball_grad, zero),
            torch.where(sb, energy, zero),
        ])
        ns = SDState(world=world, steps=state.steps + 1, shaping=shaping)
        info = {k: shaping[i] for i, k in enumerate(_SHAPING_KEYS)}
        return ns, reward, done, info
