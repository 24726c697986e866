"""SSLContestedPossession-v0: steal the ball from a holding enemy and score.

Port of ``rsoccer_tpu/envs/ssl_contested_possession.py`` (reference
ssl/ssl_hw_challenge/contested_possession.py) on batch-last tensors:

  - Obs Box(14): ball 4 + blue 8 + yellow 2.
  - Action Box(5): as StaticDefenders.
  - Reward: goal +5; shaped ball_dist + ball_grad + energy otherwise.  A
    moving yellow (|v| > 0.1) is a collision that ends the episode, and
    the shaping still pays on that step (the reference's collision check
    is independent of its if/elif chain, :136-208).
  - Reset: blue at the origin; the enemy uniform in the penalty strip
    facing away (theta = pi); the ball 0.1 m in front of it.
  - 1200-step TimeLimit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rsoccer_tpu_torch.core.state import WorldState
from rsoccer_tpu_torch.envs.ssl_common import SSLTaskBase, termination_chain

_SHAPING_KEYS = (
    "goal",
    "rbt_in_gk_area",
    "done_ball_out",
    "done_ball_out_right",
    "done_rbt_out",
    "ball_dist",
    "ball_grad",
    "energy",
    "collision",
)


class CPState(NamedTuple):
    world: WorldState
    steps: torch.Tensor  # (B,) int32
    shaping: torch.Tensor  # (9, B) accumulators, order _SHAPING_KEYS


class SSLContestedPossessionEnv(SSLTaskBase):
    obs_size = 14
    action_size = 5
    max_episode_steps = 1200  # rsoccer_gym/__init__.py:23

    def __init__(self, field_type: int = 2, time_step: float = 0.025):
        super().__init__(field_type, n_blue=1, n_yellow=1, time_step=time_step)
        self.obs_size = 4 + 8 * self.n_blue + 2 * self.n_yellow
        f = self.field
        # reward scales (reference :54-61)
        self.ball_dist_scale = math.sqrt(f.width ** 2 + (f.length / 2) ** 2)
        self.ball_grad_scale = math.sqrt((f.width / 2) ** 2 + (f.length / 2) ** 2) / 4
        self.energy_scale = 160.0 * 4 * 1200

    def observe(self, state) -> torch.Tensor:
        return self.observe_standard(state.world)

    def reset_noise_spec(self):
        return {"enemy": ((2,), "uniform")}

    def reset_state(self, noise):
        f = self.field
        enemy_x = f.penalty_length + noise["enemy"][0] * (f.half_length - 2 * f.penalty_length)
        enemy_y = -f.penalty_width / 2 + noise["enemy"][1] * f.penalty_width
        z = torch.zeros_like(enemy_x)
        world = self.make_world(
            ball_x=enemy_x - 0.1, ball_y=enemy_y,
            rx=torch.stack([z, enemy_x]), ry=torch.stack([z, enemy_y]),
            rtheta=torch.stack([z, torch.full_like(z, math.pi)]),
        )
        return CPState(
            world=world,
            steps=torch.zeros_like(z, dtype=torch.int32),
            shaping=torch.zeros((len(_SHAPING_KEYS),) + z.shape, device=z.device),
        )

    def transition(self, state: CPState, action, noise):
        world = self._physics(state.world, self.task_commands(state, action))
        # the collision check is independent of the chain (reference :165-169)
        collision = (torch.abs(world.robots.v_x[1]) > 0.1) | (
            torch.abs(world.robots.v_y[1]) > 0.1
        )
        c_rbt_out, c_gk, c_ball_out, goal, ball_out_right, chain_done = termination_chain(
            self.field, world.robots.x[0], world.robots.y[0], world.ball.x, world.ball.y
        )
        sb = ~chain_done  # shaping still pays on collision steps
        done = collision | chain_done

        ball_dist = self.ball_dist_rw(world, state.world) / self.ball_dist_scale
        ball_grad = self.ball_grad_rw(world, state.world) / self.ball_grad_scale
        energy = -self.energy_pen(world) / self.energy_scale
        shaped = ball_dist + ball_grad + energy
        reward = torch.where(goal, 5.0, torch.where(sb, shaped, 0.0))

        zero = torch.zeros_like(reward)
        shaping = state.shaping + torch.stack([
            goal.to(zero.dtype), c_gk.to(zero.dtype), c_ball_out.to(zero.dtype),
            ball_out_right.to(zero.dtype), c_rbt_out.to(zero.dtype),
            torch.where(sb, ball_dist, zero),
            torch.where(sb, ball_grad, zero),
            torch.where(sb, energy, zero),
            collision.to(zero.dtype),
        ])
        ns = CPState(world=world, steps=state.steps + 1, shaping=shaping)
        info = {k: shaping[i] for i, k in enumerate(_SHAPING_KEYS)}
        return ns, reward, done, info
