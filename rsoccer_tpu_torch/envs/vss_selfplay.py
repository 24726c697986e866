"""VSSSelfPlay-v0: both teams under policy control, with mirrored views.

Port of ``rsoccer_tpu/envs/vss_selfplay.py``.  A ``(2 * n_robots, B)``
action, wheel fractions for every robot (blues first, robot-major), and
the opponent's view: the world rotated 180 degrees with the teams swapped,
so a policy trained as "blue attacking +x" drives the yellow team
unchanged (wheel commands are body-frame).  Physics, observation layout,
rewards (blue-centric), resets and the 1200-step limit are VSS-v0's; no
OU draw (``ou_x`` is carried unchanged, for ``models/selfplay``'s OU
lanes).  Not part of the reference surface; registered as
``VSSSelfPlay-v0``.
"""

from __future__ import annotations

import math

import torch

from rsoccer_tpu_torch.core.state import BallState, RobotsState, VSSCommands, WorldState
from rsoccer_tpu_torch.envs.vss import VSSEnv
from rsoccer_tpu_torch.physics.common import wrap_angle


class VSSSelfPlayEnv(VSSEnv):
    """3v3 with every robot under policy control (blue rows, then yellow)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.n_blue != self.n_yellow:
            raise ValueError(
                "self-play mirroring needs equal team sizes, got "
                f"{self.n_blue}v{self.n_yellow}"
            )
        self.action_size = 2 * self.n_robots

    def transition_noise_spec(self):
        return {}  # no OU: both teams are policy-driven

    def pre_physics(self, state, action, noise):
        wl, wr = self._actions_to_wheels(action.reshape(self.n_robots, 2, -1))
        return VSSCommands(v_wheel0=wl, v_wheel1=wr), (state.ou_x, wl, wr)

    # ------------------------------------------------------------- mirror
    def mirror_world(self, world: WorldState) -> WorldState:
        """The world as the yellow team sees it if it called itself blue:
        rotation by pi about the centre ((x, y) -> (-x, -y), theta ->
        theta + pi, planar velocities negate; angular velocity and the
        vertical axis are invariant), teams swapped."""
        nb = self.n_blue
        rb, b = world.robots, world.ball

        def swap(a):
            return torch.cat([a[nb:], a[:nb]], dim=0)

        return WorldState(
            ball=BallState(x=-b.x, y=-b.y, z=b.z, v_x=-b.v_x, v_y=-b.v_y, v_z=b.v_z),
            robots=RobotsState(
                x=swap(-rb.x),
                y=swap(-rb.y),
                theta=wrap_angle(swap(rb.theta) + math.pi),
                v_x=swap(-rb.v_x),
                v_y=swap(-rb.v_y),
                v_theta=swap(rb.v_theta),
                infrared=swap(rb.infrared),
                v_wheel=swap(rb.v_wheel),
            ),
        )

    def observe_opponent(self, state) -> torch.Tensor:
        """The VSS observation ``(obs_size, B)`` from the yellow team's
        side."""
        return self.observe(state._replace(world=self.mirror_world(state.world)))
