"""Authoring a custom task env — the port's counterpart of
``examples/custom_env.py`` (the reference README's custom-env example,
subclass + hook overrides, reference README.md:60-112): define reset,
transition and observe on top of the shared physics, on batch-last
tensors, and run it batched through ``BatchedEnv`` (its plain path: a
custom task has no fused kernel).

Task: a single VSS robot must touch the ball, which starts at the penalty
edge.  Reward 1 and terminate on touch.  It draws no noise, so every env
of a batch runs the same course.

    python -m rsoccer_tpu_torch.examples.custom_env --envs 8192
    python -m rsoccer_tpu_torch.examples.custom_env --device cpu --envs 16
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import torch

from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.core.field import vss_field
from rsoccer_tpu_torch.core.state import BallState, RobotsState, VSSCommands, WorldState
from rsoccer_tpu_torch.envs.base import Env
from rsoccer_tpu_torch.models.networks import check_device
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.physics.config import VSS_PHYSICS
from rsoccer_tpu_torch.physics.vss import make_vss_step


class ReachState(NamedTuple):
    world: WorldState
    steps: torch.Tensor  # (B,) int32


class ReachBallEnv(Env):
    """1 blue robot, fixed spawn, touch-the-ball task."""

    obs_size = 6
    action_size = 2
    max_episode_steps = 300
    league = "vss"

    def __init__(self):
        self.field = vss_field(0)
        self.n_blue, self.n_yellow = 1, 0
        self._physics = make_vss_step(self.field, VSS_PHYSICS, 0.025)

    def reset_state(self, noise):
        # no reset noise: the batch comes from the pad block the batched
        # env hands a reset that draws nothing
        pad = noise["_pad"]
        f = self.field
        zb = torch.zeros(pad.shape[-1], device=pad.device)
        z1 = zb[None]
        world = WorldState(
            ball=BallState(
                x=zb + (f.half_length - f.penalty_length), y=zb, z=zb + f.ball_radius,
                v_x=zb, v_y=zb, v_z=zb,
            ),
            robots=RobotsState(
                x=z1, y=z1, theta=z1, v_x=z1, v_y=z1, v_theta=z1,
                infrared=torch.zeros_like(z1, dtype=torch.bool),
                v_wheel=torch.zeros((1, 4, pad.shape[-1]), device=pad.device),
            ),
        )
        return ReachState(world=world, steps=torch.zeros_like(zb, dtype=torch.int32))

    def observe(self, state):
        w = state.world
        return torch.stack([
            w.ball.x, w.ball.y, w.robots.x[0], w.robots.y[0],
            torch.sin(w.robots.theta[0]), torch.cos(w.robots.theta[0]),
        ])

    def transition(self, state, action, noise):
        max_wheel = self.field.max_wheel_rad_s
        cmd = VSSCommands(v_wheel0=action[:1] * max_wheel, v_wheel1=action[1:] * max_wheel)
        world = self._physics(state.world, cmd)
        dist = torch.hypot(world.ball.x - world.robots.x[0], world.ball.y - world.robots.y[0])
        touched = dist < self.field.rbt_radius + self.field.ball_radius + 0.01
        reward = torch.where(touched, 1.0, 0.0)
        return ReachState(world=world, steps=state.steps + 1), reward, touched, {}


def touch_steps(n_envs: int, device="cuda", max_steps: int = 300) -> torch.Tensor:
    """Drive every env straight at the ball (dead ahead at reset) through
    ``BatchedEnv.step``; returns each env's first touch step, -1 where
    none came within ``max_steps`` (on ``device``)."""
    benv = BatchedEnv(ReachBallEnv(), n_envs, device=check_device(device))
    key = make_key(0, device=benv.device)  # the task draws no noise
    state, _ = benv.reset(key)
    actions = torch.ones((2, n_envs), device=benv.device)
    first = torch.full((n_envs,), -1, dtype=torch.int64, device=benv.device)
    for t in range(max_steps):
        state, obs, r, term, trunc, info = benv.step(state, actions, key)
        first = torch.where(term & (first < 0), t, first)
    return first


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--envs", type=int, default=8192)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    first = touch_steps(args.envs, args.device).cpu()
    if bool((first < 0).any()):
        print(f"{int((first < 0).sum())} of {args.envs} envs never touched the ball (unexpected)")
        return 1
    steps = sorted(set(first.tolist()))
    print(f"{args.envs} envs touched the ball at step {steps[0] if len(steps) == 1 else steps}, reward 1.0")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
