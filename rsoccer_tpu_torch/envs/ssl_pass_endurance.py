"""SSLPassEndurance-v0: a shooter passes to a frozen receiver.

Port of ``rsoccer_tpu/envs/ssl_pass_endurance.py`` (reference
ssl/ssl_hw_challenge/pass_endurance.py) on batch-last tensors:

  - Obs Box(16): ball 4 + 2 blues x [x, y, sin, cos, norm_w(v_theta),
    infrared in {0, 1}].
  - Action Box(3): shooter vtheta, kick (|a| > 0.5 deadzone), dribbler.  The
    shooter cannot translate; the receiver is frozen with its dribbler
    always on.
  - Reward: +1 and done when the receiver's infrared fires; otherwise
    ball_grad toward the receiver over ``ball_grad_scale``; -1 and done on
    a "wrong ball" (the ball leaves the shooter-receiver bounding box, in
    integer centimetres truncated toward zero, or keeps a constant
    receiver distance for > 20 steps).
  - ``reversed_dist`` is written (not accumulated) on terminated steps.
  - Reset: ball uniform in the +-1.5 square; shooter 0.115 m beyond it on
    the |y| side, facing it; receiver mirrored in y, its x the first of
    ``N_CAND`` candidates at least 1 m from the ball's, aimed back at the
    shooter.  1200-step TimeLimit.

``curriculum``, ``catch_scale`` and ``aim_shaping`` are the JAX package's
training-time extensions (see its docstring); the fused step refuses them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rsoccer_tpu_torch.core.state import WorldState, zero_ssl_commands
from rsoccer_tpu_torch.envs import spawn
from rsoccer_tpu_torch.envs.ssl_common import SSLTaskBase

_SHAPING_KEYS = ("reversed_dist", "ball_grad")
N_CAND = 16


class PEState(NamedTuple):
    world: WorldState
    steps: torch.Tensor  # (B,) int32
    stopped_steps: torch.Tensor  # (B,) int32
    shaping: torch.Tensor  # (2, B) [reversed_dist (written), ball_grad (summed)]


class SSLPassEnduranceEnv(SSLTaskBase):
    obs_size = 16
    action_size = 3
    max_episode_steps = 1200  # rsoccer_gym/__init__.py:29
    max_kick_x = 5.0

    def __init__(self, field_type: int = 2, time_step: float = 0.025,
                 curriculum: bool = False, catch_scale: float = 1.0,
                 aim_shaping: float = 0.0):
        super().__init__(field_type, n_blue=2, n_yellow=0, time_step=time_step)
        self.obs_size = 4 + 6 * self.n_blue
        self.catch_scale = float(catch_scale)
        self.curriculum = curriculum
        self.aim_shaping = float(aim_shaping)
        f = self.field
        self.ball_grad_scale = math.sqrt((f.width / 2) ** 2 + (f.length / 2) ** 2) / 4

    # ------------------------------------------------------------------ obs
    def observe(self, state) -> torch.Tensor:
        b, rb = state.world.ball, state.world.robots
        rows = [self._norm_pos(b.x), self._norm_pos(b.y), self._norm_v(b.v_x), self._norm_v(b.v_y)]
        for i in range(self.n_robots):
            rows += [
                self._norm_pos(rb.x[i]), self._norm_pos(rb.y[i]),
                torch.sin(rb.theta[i]), torch.cos(rb.theta[i]),
                self._norm_w(rb.v_theta[i]),
                torch.where(rb.infrared[i], 1.0, 0.0),
            ]
        return torch.stack(rows)

    # ---------------------------------------------------------------- reset
    def reset_noise_spec(self):
        return {"ball": ((2,), "uniform"), "recv_x": ((N_CAND,), "uniform")}

    def reset_state(self, noise):
        bxy = -1.5 + noise["ball"] * 3.0
        ball_x, ball_y = bxy[0], bxy[1]
        factor = torch.where(ball_y >= 0, 1.0, -1.0)
        shooter_x = ball_x
        shooter_y = ball_y + 0.115 * factor
        # 270 deg (facing -y) when above, 90 deg (facing +y) when below
        shooter_theta = torch.where(factor > 0, -math.pi / 2, math.pi / 2)

        # receiver x: uniform +-1.5, rejected to |recv_x - ball_x| >= 1
        cand = -1.5 + noise["recv_x"] * 3.0
        (recv_x,) = spawn.pick_first(torch.abs(cand - ball_x) >= 1.0, cand)
        if self.curriculum:
            # distance curriculum: offset 0.25..2.5 m, either side, folded
            # back into the +-1.5 region; flipped to the roomier side if
            # clipping collapsed it
            dist = 0.25 + noise["recv_x"][0] * 2.25
            side = torch.where(noise["recv_x"][1] < 0.5, -1.0, 1.0)
            recv_x = torch.clamp(ball_x + side * dist, -1.5, 1.5)
            recv_x = torch.where(torch.abs(recv_x - ball_x) < 0.25,
                                 torch.clamp(ball_x - side * dist, -1.5, 1.5), recv_x)
        recv_y = -ball_y
        recv_theta = torch.atan2(recv_y - shooter_y, recv_x - shooter_x) + math.pi  # aimed back

        z = torch.zeros_like(ball_x)
        world = self.make_world(
            ball_x, ball_y,
            rx=torch.stack([shooter_x, recv_x]), ry=torch.stack([shooter_y, recv_y]),
            rtheta=torch.stack([shooter_theta, recv_theta]),
        )
        steps = torch.zeros_like(z, dtype=torch.int32)
        return PEState(world=world, steps=steps, stopped_steps=steps.clone(),
                       shaping=torch.zeros((2,) + z.shape, device=z.device))

    def _widened_catch(self, world: WorldState):
        """The pass-received test with the receiver's kicker face widened
        by ``catch_scale`` (physics/ssl's face zone, a wider lateral window
        and a little extra depth)."""
        f, cfg = self.field, self.physics_cfg
        dx = world.ball.x - world.robots.x[1]
        dy = world.ball.y - world.robots.y[1]
        c, s = torch.cos(world.robots.theta[1]), torch.sin(world.robots.theta[1])
        lx = dx * c + dy * s
        ly = -dx * s + dy * c
        lo = f.rbt_distance_center_kicker - f.rbt_kicker_thickness - f.ball_radius
        hi = (f.rbt_distance_center_kicker + f.ball_radius + cfg.kicker_depth_slack
              + (self.catch_scale - 1.0) * 0.02)
        low = (world.ball.z - f.ball_radius) <= cfg.kicker_height
        return ((lx >= lo) & (lx <= hi)
                & (torch.abs(ly) <= f.rbt_kicker_width / 2 * self.catch_scale) & low)

    # ----------------------------------------------------------------- step
    def transition(self, state: PEState, action, noise):
        kick = torch.where(torch.abs(action[1]) > 0.5, action[1], 0.0)  # reference :108
        b = action.shape[-1]
        cmd = zero_ssl_commands(self.n_robots, b, action.device)
        zero = torch.zeros_like(kick)
        cmd = cmd._replace(
            v_theta=torch.stack([action[0] * self.max_w_cmd, zero]),
            kick_v_x=torch.stack([kick * self.max_kick_x, zero]),
            dribbler=torch.stack([action[2] > 0, torch.ones_like(kick, dtype=torch.bool)]),
        )
        world = self._physics(state.world, cmd)

        bx, by = world.ball.x, world.ball.y
        sx, sy = world.robots.x[0], world.robots.y[0]
        rx, ry = world.robots.x[1], world.robots.y[1]
        if self.catch_scale != 1.0:
            received = self._widened_catch(world)
        else:
            received = world.robots.infrared[1]

        # ball_grad toward the receiver (reference :216-233)
        lb = state.world.ball
        last_d = self.dist(lb.x, lb.y, rx, ry)
        d = self.dist(bx, by, rx, ry)
        ball_grad = torch.clamp(last_d - d, -1.0, 1.0) / self.ball_grad_scale

        # wrong ball: integer-centimetre bounding box (int() truncates
        # toward zero) and the stopped counter (reference :187-214)
        def cm(v):
            return torch.trunc(v * 100).to(torch.int32)

        cbx, cby, csx, csy, crx, cry = (cm(v) for v in (bx, by, sx, sy, rx, ry))
        inside = ((torch.minimum(crx, csx) <= cbx) & (cbx <= torch.maximum(crx, csx))
                  & (torch.minimum(cry, csy) <= cby) & (cby <= torch.maximum(cry, csy)))
        stopped = torch.abs(last_d - d) < 0.01
        stopped_steps = torch.where(stopped, state.stopped_steps + 1, 0).to(torch.int32)
        wrong = (stopped_steps > 20) | ~inside

        reward = torch.where(received, 1.0, ball_grad) + torch.where(wrong, -1.0, 0.0)
        if self.aim_shaping:
            bvx, bvy = world.ball.v_x, world.ball.v_y
            speed = torch.sqrt(bvx * bvx + bvy * bvy)
            tx, ty = rx - bx, ry - by
            cosang = (bvx * tx + bvy * ty) / (speed * torch.sqrt(tx * tx + ty * ty) + 1e-6)
            aim_err = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
            reward = reward - self.aim_shaping * aim_err * (speed > 1.0)
        done = received | wrong

        # reversed_dist written on terminated steps (reference :146-155)
        dist_robs = self.dist(rx, ry, sx, sy)
        reversed_dist = (dist_robs - d) / torch.clamp_min(dist_robs, 1e-8)
        shaping = torch.stack([
            torch.where(done, reversed_dist, state.shaping[0]),
            state.shaping[1] + torch.where(received, 0.0, ball_grad),
        ])
        ns = PEState(world=world, steps=state.steps + 1, stopped_steps=stopped_steps,
                     shaping=shaping)
        info = {k: shaping[i] for i, k in enumerate(_SHAPING_KEYS)}
        return ns, reward, done, info
