"""Gymnasium VectorEnv wrapper over the port's batched envs.

Port of ``rsoccer_tpu/gym_compat/vector.py``: the batched engine behind
gymnasium's standard ``VectorEnv`` interface, numpy in, numpy out.  The work
is ``batch/host.HostVectorEnv`` (no gymnasium inside); this class adds the
spaces and the metadata.

Auto-reset follows gymnasium's SAME_STEP convention
(``metadata["autoreset_mode"] = AutoresetMode.SAME_STEP``): the step that
ends an episode returns the *reset* observation, while the final pre-reset
observation and that episode's info are surfaced under ``infos["final_obs"]``
/ ``infos["final_info"]`` with the standard ``_final_obs`` mask.
"""

from __future__ import annotations

from typing import Optional

import gymnasium as gym
import numpy as np

from rsoccer_tpu_torch.batch.host import HostVectorEnv


class VectorGymnasiumEnv(gym.vector.VectorEnv):
    """numpy-facing vectorised env over :class:`HostVectorEnv`."""

    metadata = {"autoreset_mode": gym.vector.AutoresetMode.SAME_STEP}

    def __init__(
        self,
        env_id: str,
        num_envs: int,
        fused: bool = False,
        fused_rng: str = "input",
        device="cuda",
        **kwargs,
    ):
        """``fused=True`` backs the wrapper with the fused full-step kernels
        (their ``emit_final`` variant supplies ``final_obs``)."""
        self.host = HostVectorEnv(env_id, num_envs, device=device, fused=fused,
                                  fused_rng=fused_rng, **kwargs)
        self.env = self.host.env
        self.benv = self.host.benv
        self.num_envs = num_envs
        self.single_action_space = gym.spaces.Box(
            low=-1, high=1, shape=(self.env.action_size,), dtype=np.float32
        )
        self.single_observation_space = gym.spaces.Box(
            low=-1.2, high=1.2, shape=(self.env.obs_size,), dtype=np.float32
        )
        self.action_space = gym.vector.utils.batch_space(self.single_action_space, num_envs)
        self.observation_space = gym.vector.utils.batch_space(
            self.single_observation_space, num_envs
        )

    def reset(self, *, seed: Optional[int] = None, options=None):
        return self.host.reset(seed)

    def step(self, actions):
        return self.host.step(actions)

    def close_extras(self, **kwargs):
        pass
