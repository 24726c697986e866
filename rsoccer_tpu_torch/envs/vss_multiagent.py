"""VSSMultiAgent-v0: every blue robot under policy control (extension).

Port of ``rsoccer_tpu/envs/vss_multiagent.py``.  VSS-v0's physics,
observation layout, rewards and resets, with a ``(2 * n_blue, B)`` action
(wheel fractions per blue robot, robot-major, VSS-v0's per-wheel
conversion); the yellow robots stay OU-driven.  The reward is VSS-v0's
team-level shaping computed for robot 0.  Not part of the reference
surface; registered as ``VSSMultiAgent-v0``.
"""

from __future__ import annotations

import torch

from rsoccer_tpu_torch.core.state import VSSCommands
from rsoccer_tpu_torch.envs import ou
from rsoccer_tpu_torch.envs.vss import VSSEnv


class VSSMultiAgentEnv(VSSEnv):
    """3v3 with every blue robot under policy control."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.action_size = 2 * self.n_blue

    def pre_physics(self, state, action, noise):
        """Commands from the blue actions ``(2 * n_blue, B)`` and the OU
        process's yellow rows."""
        ou_x = ou.ou_update(state.ou_x, noise["ou"], self.time_step)
        blue = action.reshape(self.n_blue, 2, -1)
        wl, wr = self._actions_to_wheels(torch.cat([blue, ou_x[self.n_blue:]], dim=0))
        return VSSCommands(v_wheel0=wl, v_wheel1=wr), (ou_x, wl, wr)
