"""SSLDribbling-v0: slalom a 4-gate course while keeping the ball.

Port of ``rsoccer_tpu/envs/ssl_dribbling.py`` (reference
ssl/ssl_hw_challenge/dribbling.py) on batch-last tensors:

  - Obs Box(21): checkpoint progress ((count/6)*2 - 1) + ball 4 + blue 8
    (infrared in {-1, 1}) + 4 yellows x 2.
  - Action Box(4): global vx, vy, vtheta, dribbler; no kicker.
  - Reward +1 per checkpoint crossing: the gate automaton over ball-y sign
    changes inside the x-windows between the nodes at x = -0.5, -1, -1.5,
    -2; 7 crossings complete the course.
  - Termination: a moving yellow (|v| > 0.05), the robot leaving the
    margin-1 course box, reverse-crossing the last gate, or count == 7.
    4800-step TimeLimit.
  - Reset is deterministic: it draws no noise.

``curriculum`` is the JAX package's training-time extension (staged resets
and potential shaping toward the next gate); the fused step refuses it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rsoccer_tpu_torch.core.state import WorldState
from rsoccer_tpu_torch.envs.ssl_common import SSLTaskBase

NODES = (-0.5, -1.0, -1.5, -2.0)  # reference :60-63
MARGIN = 1.0  # reference :64


class DribblingState(NamedTuple):
    world: WorldState
    steps: torch.Tensor  # (B,) int32
    checkpoints: torch.Tensor  # (B,) int32 count, 0..7


def _select(index, table, n: int):
    """``table[index]`` per lane as a one-hot masked sum (exact: one
    nonzero term), as the JAX package selects."""
    onehot = torch.arange(n, device=index.device)[:, None] == index[None]
    t = torch.tensor(table, dtype=torch.float32, device=index.device)[:, None]
    return torch.where(onehot, t, 0.0).sum(0)


class SSLDribblingEnv(SSLTaskBase):
    obs_size = 21
    action_size = 4
    max_episode_steps = 4800  # rsoccer_gym/__init__.py:17

    def __init__(self, field_type: int = 2, time_step: float = 0.025,
                 curriculum: bool = False):
        super().__init__(field_type, n_blue=1, n_yellow=4, time_step=time_step)
        self.obs_size = 5 + 8 * self.n_blue + 2 * self.n_yellow
        self.curriculum = curriculum

    def _observe(self, world: WorldState, checkpoints) -> torch.Tensor:
        head = (checkpoints.to(torch.float32) / 6.0) * 2.0 - 1.0  # reference :80
        rest = self.observe_standard(world, infrared_low=-1.0)  # reference :98
        return torch.cat([head[None], rest])

    def observe(self, state) -> torch.Tensor:
        return self._observe(state.world, state.checkpoints)

    # ---------------------------------------------------------------- reset
    def reset_noise_spec(self):
        if not self.curriculum:
            return {}
        return {"stage": ((1,), "uniform"), "place": ((3,), "uniform")}

    def reset_state(self, noise):
        if not self.curriculum:
            # deterministic placement (reference :187-202); the batch comes
            # from draw_noise's pad block
            z = torch.zeros_like(noise["_pad"][0])
            ball_x, ball_y = torch.full_like(z, -0.1), z
            blue_x, blue_y = z, z
            stage = torch.zeros_like(z, dtype=torch.int32)
        else:
            stage = torch.clamp(torch.floor(noise["stage"][0] * 7.0).to(torch.int32), 0, 6)
            # per-stage ball boxes just up-course of the next gate the
            # automaton expects (see the JAX package's comment)
            x_lo = _select(stage, [-0.10, -1.45, -1.95, -2.60, -1.95, -2.60, -1.95], 7)
            x_hi = _select(stage, [-0.10, -1.05, -1.60, -2.05, -1.60, -2.05, -1.60], 7)
            y_lo = _select(stage, [0.0, -0.30, 0.20, -0.30, 0.20, -0.30, 0.20], 7)
            y_hi = _select(stage, [0.0, -0.20, 0.30, -0.20, 0.30, -0.20, 0.30], 7)
            u = noise["place"]
            ball_x = x_lo + (x_hi - x_lo) * u[0]
            ball_y = y_lo + (y_hi - y_lo) * u[1]
            # the robot behind the ball w.r.t. the course direction (-x)
            blue_x = torch.where(stage == 0, 0.0, ball_x + 0.13)
            blue_y = torch.where(stage == 0, 0.0, ball_y)
        nodes = torch.tensor(NODES, dtype=torch.float32, device=ball_x.device)[:, None]
        world = self.make_world(
            ball_x=ball_x, ball_y=ball_y,
            rx=torch.cat([blue_x[None], nodes.expand(4, ball_x.shape[-1])]),
            ry=torch.cat([blue_y[None], torch.zeros((4,) + ball_x.shape, device=ball_x.device)]),
            rtheta=torch.full((5,) + ball_x.shape, math.pi, device=ball_x.device),  # 180 degrees
        )
        return DribblingState(world=world, steps=torch.zeros_like(stage), checkpoints=stage)

    # ----------------------------------------------------------------- step
    def transition(self, state: DribblingState, action, noise):
        v_x, v_y, v_theta = self.convert_actions(action, state.world.robots.theta[0])
        commands = self.single_robot_commands(
            v_x, v_y, v_theta, kick_v_x=torch.zeros_like(v_x), dribbler=action[3] > 0
        )
        world = self._physics(state.world, commands)

        rb = world.robots
        bx, by = world.ball.x, world.ball.y
        last_by = state.world.ball.y
        count = state.checkpoints

        # collision: any yellow robot moving (reference :143-145)
        collision = ((torch.abs(rb.v_x[1:]) > 0.05) | (torch.abs(rb.v_y[1:]) > 0.05)).any(0)
        # course box (reference :147-152)
        rx, ry = rb.x[0], rb.y[0]
        rbt_out = (rx < NODES[3] - MARGIN) | (rx > MARGIN) | (torch.abs(ry) > MARGIN)

        down = (last_by >= 0) & (by < 0)  # y crossed downward
        up = (last_by < 0) & (by >= 0)  # y crossed upward

        # gate automaton (reference :156-181), active only in bounds
        in01 = (bx < NODES[0]) & (bx > NODES[1])
        in12 = (bx < NODES[1]) & (bx > NODES[2])
        in23 = (bx < NODES[2]) & (bx > NODES[3])
        in3m = (bx > NODES[3] - MARGIN) & (bx < NODES[3])
        even_ge2 = (count >= 2) & (count % 2 == 0)
        odd_ge2 = (count >= 2) & (count % 2 == 1)
        cross0 = (count == 0) & in01 & down
        cross1 = (count == 1) & in12 & up
        cross_even = even_ge2 & in23 & down
        reverse_even = even_ge2 & in23 & up
        cross_odd = odd_ge2 & in3m & up
        crossed = ~rbt_out & (cross0 | cross1 | cross_even | cross_odd)
        reversed_gate = ~rbt_out & reverse_even
        new_count = count + crossed.to(count.dtype)
        completed = ~rbt_out & cross_even & (new_count == 7)

        reward = torch.where(crossed, 1.0, 0.0)
        if self.curriculum:
            # potential shaping toward the next gate the automaton expects,
            # two-phase (approach side outside the gate's window, exit side
            # inside; see the JAX package's comment); curriculum only
            obx, oby = state.world.ball.x, state.world.ball.y
            gx = _select(count, [-0.75, -1.25, -1.75, -2.50, -1.75, -2.50, -1.75, -1.75], 8)
            w_lo = _select(count, [NODES[1], NODES[2], NODES[3], NODES[3] - MARGIN,
                                   NODES[3], NODES[3] - MARGIN, NODES[3], NODES[3]], 8)
            w_hi = _select(count, [NODES[0], NODES[1], NODES[2], NODES[3],
                                   NODES[2], NODES[3], NODES[2], NODES[2]], 8)
            downward = (count == 0) | ((count >= 2) & (count % 2 == 0))
            in_w = (obx > w_lo + 0.15) & (obx < w_hi - 0.15)
            gy = torch.where(downward, torch.where(in_w, -0.15, 0.35),
                             torch.where(in_w, 0.15, -0.35))
            d_new = torch.hypot(bx - gx, by - gy)
            d_old = torch.hypot(obx - gx, oby - gy)
            reward = reward + 0.5 * (d_old - d_new)
        done = collision | rbt_out | reversed_gate | completed

        ns = DribblingState(world=world, steps=state.steps + 1, checkpoints=new_count)
        return ns, reward, done, {}  # no info keys (the reference's step is the base's)
