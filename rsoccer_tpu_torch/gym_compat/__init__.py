"""Gymnasium-compatible wrapper — drop-in parity with the reference API.

Port of ``rsoccer_tpu/gym_compat/__init__.py``.  The reference exposes
classic Gymnasium class envs (``gym.make("VSS-v0")`` etc.,
rsoccer_gym/__init__.py:3-30); this wraps the port's batch-last envs in a
``gymnasium.Env`` so reference users keep their training loops: same ids,
spaces, reset/step/render/close signatures, degree-based ``frame``
attribute, and info dicts.  The work is ``batch/host.HostEnv`` (no
gymnasium inside); this class adds the spaces, the renderer and gymnasium's
seeding.

Differences (documented, deliberate), as in the JAX package:
  - Seeding actually works: ``reset(seed=...)`` drives every downstream
    sample through an explicit Philox key (the reference draws spawns from
    the global ``random`` module and OU noise from global numpy).
  - Episode truncation is built in (the wrapper counts its own steps
    against the registry's ``max_episode_steps``); wrapping in
    ``TimeLimit`` again is a no-op but harmless.
  - The env runs on ``device``, the card unless the caller asks for the
    CPU: ``gym.make("VSS-v0", device="cpu")``.

Call :func:`register_gymnasium` once to register every id of
``registered_ids()`` under gymnasium's global registry.  Ids already there
are skipped, as in the JAX package: a process that registered the JAX
package's wrappers first keeps them (check ``gym.spec(id).entry_point``).
"""

from __future__ import annotations

from typing import Optional

import gymnasium as gym
import numpy as np

from rsoccer_tpu_torch.batch.host import HostEnv
from rsoccer_tpu_torch.registry import registered_ids

ENTRY_POINT = "rsoccer_tpu_torch.gym_compat:GymnasiumEnv"


class GymnasiumEnv(gym.Env):
    """Single-env host-side wrapper around one of the port's envs."""

    metadata = {
        "render.modes": ["human", "rgb_array"],
        "render_modes": ["human", "rgb_array"],
        "render_fps": 60,
        "render.fps": 60,
    }

    def __init__(self, env_id: str, render_mode: Optional[str] = None, device="cuda", **kwargs):
        super().__init__()
        self.host = HostEnv(env_id, device=device, **kwargs)
        self.env = self.host.env
        self.env_id = env_id
        self.render_mode = render_mode
        self.action_space = gym.spaces.Box(
            low=-1, high=1, shape=(self.env.action_size,), dtype=np.float32
        )
        self.observation_space = gym.spaces.Box(
            low=-1.2, high=1.2, shape=(self.env.obs_size,), dtype=np.float32
        )
        self._renderer = None

    # -- gymnasium API ------------------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options=None):
        # seed gymnasium's np_random too (check_env expects
        # super().reset(seed=...) semantics); the env's randomness flows
        # through the Philox key
        super().reset(seed=seed)
        out = self.host.reset(seed)
        if self.render_mode == "human":
            self.render()
        return out

    def step(self, action):
        out = self.host.step(action)
        if self.render_mode == "human":
            self.render()
        return out

    @property
    def steps(self) -> int:
        return self.host.steps

    @property
    def frame(self):
        """Degree-based Frame view of the current state (reference
        ``self.frame``, vss_gym_base.py:61)."""
        return self.host.frame

    def render(self):
        from rsoccer_tpu_torch.render.renderer import Renderer

        if self._renderer is None:
            self._renderer = Renderer(self.env.league, self.render_mode or "rgb_array")
        return self._renderer.render_frame(self.frame)

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None

    # compatibility accessors mirroring the reference base classes
    @property
    def field(self):
        return self.env.field

    @property
    def n_robots_blue(self):
        return self.env.n_blue

    @property
    def n_robots_yellow(self):
        return self.env.n_yellow


def register_gymnasium():
    """Register every id of ``registered_ids()`` in gymnasium's global
    registry with this module's entry point, skipping ids already there
    (rsoccer_gym/__init__.py:3-30; step limits come from the envs)."""
    for env_id in registered_ids():
        if env_id in gym.registry:
            continue
        gym.register(id=env_id, entry_point=ENTRY_POINT, kwargs={"env_id": env_id})
