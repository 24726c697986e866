"""The numpy-facing half of the gymnasium wrappers, without gymnasium.

``HostEnv`` is the single env of ``rsoccer_tpu/gym_compat/__init__.py``'s
``GymnasiumEnv`` and ``HostVectorEnv`` the batched env of
``rsoccer_tpu/gym_compat/vector.py``'s ``VectorGymnasiumEnv``: numpy in,
numpy out, the envs on ``device`` (the card unless the caller asks for the
CPU; on a machine without one the default raises).  The gymnasium classes
(``rsoccer_tpu_torch/gym_compat``) are thin shells over these two; they
import gymnasium, which these do not, so this module runs where gymnasium
is not installed.

Each step makes ONE device-to-host copy: the step's results are stacked
into one f32 tensor on the device and copied together.

``HostVectorEnv`` auto-resets with gymnasium's SAME_STEP convention: the
step that ends an episode returns the reset obs, and the pre-reset obs and
that step's info under ``infos["final_obs"]`` / ``infos["final_info"]``,
object arrays masked by ``infos["_final_obs"]`` / ``infos["_final_info"]``.
With ``fused=True`` the step is one launch of the env's fused kernel in
its ``emit_final`` variant (``BatchedEnv.step_final``).

Randomness: ``reset(seed=...)`` makes a Philox key (``ops/philox.make_key``)
and every later draw advances it.  The JAX wrappers split a JAX key
instead: the streams differ, so the two packages agree only on injected
noise, through the ``*_with_noise`` entries.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.core.frame import frame_from_world
from rsoccer_tpu_torch.envs.base import draw_noise
from rsoccer_tpu_torch.models.networks import check_device
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.registry import make


def to_host(rows) -> np.ndarray:
    """Tensors of a trailing batch axis -> one (R, B) f32 numpy array,
    through one device-to-host copy."""
    b = rows[0].shape[-1]
    return torch.cat([r.reshape(-1, b).to(torch.float32) for r in rows]).cpu().numpy()


class HostEnv:
    """One env (a batch of 1) on ``device``, stepped with no auto-reset:
    ``reset(seed) -> (obs, {})``, ``step(action) -> (obs, reward,
    terminated, truncated, info)``, numpy in and out.  Truncation comes
    from the wrapper's own step count, as in the JAX ``GymnasiumEnv``."""

    def __init__(self, env_id: str, device="cuda", **kwargs):
        self.device = check_device(device)
        self.env = make(env_id, **kwargs)
        self.env_id = env_id
        self._r_spec = self.env.reset_noise_spec()
        self._t_spec = self.env.transition_noise_spec()
        self._key = None
        self._state = None
        self.steps = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None or self._key is None:
            self._key = make_key(0 if seed is None else seed, device=self.device)
        return self.reset_with_noise(draw_noise(self._key, self._r_spec, 1))

    def reset_with_noise(self, r_noise):
        """:meth:`reset` from an explicit reset-noise dict (blocks with a
        trailing batch of 1)."""
        self._state = self.env.reset_state(r_noise)
        self.steps = 0
        return to_host([self.env.observe(self._state)])[:, 0], {}

    def step(self, action):
        action = self._check_action(action)
        return self._step(action, draw_noise(self._key, self._t_spec, 1))

    def step_with_noise(self, action, t_noise):
        """:meth:`step` with an explicit transition-noise dict."""
        return self._step(self._check_action(action), t_noise)

    def _check_action(self, action) -> np.ndarray:
        if self._state is None:
            raise RuntimeError("step() before reset()")
        action = np.asarray(action, np.float32)
        if action.shape != (self.env.action_size,):
            raise ValueError(
                f"action shape {action.shape} does not match action space "
                f"({self.env.action_size},) for {self.env_id}"
            )
        return action

    def _step(self, action, t_noise):
        act = torch.from_numpy(action[:, None]).to(self.device)
        ns, reward, terminated, info = self.env.transition(self._state, act, t_noise)
        self._state = ns
        self.steps += 1
        host = to_host([self.env.observe(ns), reward, terminated, *info.values()])[:, 0]
        o = self.env.obs_size
        truncated = self.steps >= self.env.max_episode_steps
        return (
            host[:o],
            float(host[o]),
            bool(host[o + 1] > 0.5),
            bool(truncated),
            {k: float(v) for k, v in zip(info, host[o + 2:])},
        )

    @property
    def frame(self):
        """Degree-based Frame view of the current state (reference
        ``self.frame``, vss_gym_base.py:61)."""
        if self._state is None:
            return None
        return frame_from_world(self._state.world, self.env.n_blue, self.env.n_yellow)


class HostVectorEnv:
    """``num_envs`` envs of ``env_id`` on ``device`` through
    :class:`BatchedEnv`: ``reset(seed) -> (obs (B, O), {})``,
    ``step(actions (B, A)) -> (obs, reward, terminated, truncated,
    infos)``, numpy in and out, SAME_STEP auto-reset."""

    def __init__(self, env_id: str, num_envs: int, device="cuda", fused: bool = False,
                 fused_rng: str = "input", **kwargs):
        self.env = make(env_id, **kwargs)
        self.benv = BatchedEnv(self.env, num_envs, device=check_device(device), fused=fused,
                               fused_rng=fused_rng)
        self.num_envs = num_envs
        self._key = None
        self._state = None
        self.host_bytes = 0  # bytes the last step copied to the host

    @property
    def device(self) -> torch.device:
        return self.benv.device

    def reset(self, seed: Optional[int] = None):
        if seed is not None or self._key is None:
            self._key = make_key(0 if seed is None else seed, device=self.device)
        self._state, obs = self.benv.reset(self._key)
        return to_host([obs]).T, {}

    def reset_with_noise(self, r_noise):
        """:meth:`reset` from an explicit reset-noise dict (batch-last
        blocks)."""
        self._state, obs = self.benv.reset_with_noise(r_noise)
        return to_host([obs]).T, {}

    def step(self, actions):
        act = self._actions(actions)
        return self._host_step(self.benv.step_final(self._state, act, self._key))

    def step_with_noise(self, actions, t_noise, r_noise):
        """:meth:`step` with explicit noise dicts (batch-last blocks)."""
        act = self._actions(actions)
        return self._host_step(self.benv.step_final_with_noise(self._state, act, t_noise, r_noise))

    def _actions(self, actions) -> torch.Tensor:
        if self._state is None:
            raise RuntimeError("step() before reset()")
        actions = np.asarray(actions, np.float32)
        want = (self.num_envs, self.env.action_size)
        if actions.shape != want:
            raise ValueError(f"actions of shape {actions.shape}, want {want}")
        # (A, B) lane layout, contiguous as the kernels take it
        return torch.from_numpy(np.ascontiguousarray(actions.T)).to(self.device)

    def _host_step(self, out):
        self._state, obs, final_obs, reward, term, trunc, info = out
        host = to_host([obs, final_obs, reward, term, trunc, *info.values()])
        self.host_bytes = host.nbytes
        o = self.env.obs_size
        reward, term, trunc = host[2 * o], host[2 * o + 1] > 0.5, host[2 * o + 2] > 0.5
        infos = {k: host[2 * o + 3 + i] for i, k in enumerate(info)}
        done = term | trunc
        if done.any():
            # gymnasium SAME_STEP convention: object arrays masked by done
            fo = np.full(self.num_envs, None, dtype=object)
            fi = np.full(self.num_envs, None, dtype=object)
            final_obs_t = host[o:2 * o].T  # (B, obs)
            for i in np.nonzero(done)[0]:
                fo[i] = final_obs_t[i]
                fi[i] = {k: infos[k][i] for k in info}
            infos["final_obs"] = fo
            infos["_final_obs"] = done.copy()
            infos["final_info"] = fi
            infos["_final_info"] = done.copy()
        return host[:o].T, reward, term, trunc, infos

    @property
    def state(self):
        """The batch's state: packed ``(S, B)`` with ``fused=True``."""
        return self._state
