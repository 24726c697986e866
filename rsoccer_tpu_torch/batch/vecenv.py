"""Batched environments.

Port of ``rsoccer_tpu/batch/vecenv.py``.  The env functions already work
on batch-last tensors, so "batching" is the trailing axis itself: state
leaves ``(..., B)``, obs ``(obs_size, B)``, actions ``(action_size, B)``.

Randomness: one key tensor (``ops/philox.make_key``) for the whole batch.
A step draws its reset and transition noise as one Philox draw and
advances the key's step counter in place (``envs/base.draw_noise``).

``fused=True`` is the counterpart of the JAX package's ``pallas_full``:
the whole step is one kernel launch (``ops/vss_full.py``) on a CUDA
device — or its plain version on the CPU — and the state flows through
the rollout packed as one ``(S, B)`` tensor; :meth:`unpack_state` gives a
structured view.  ``fused_rng`` is the counterpart of ``pallas_rng``:
``"input"`` draws the noise with torch ops and passes it in as rows,
``"kernel"`` draws it inside the kernel.  Unlike on the TPU, both read
the same Philox stream, so the two modes give the same trajectory.
"""

from __future__ import annotations

import torch

from rsoccer_tpu_torch.envs.base import Env, draw_noise, step_noise_spec
from rsoccer_tpu_torch.envs.vss import _SHAPING_KEYS, VSSEnv
from rsoccer_tpu_torch.ops import vss_full


class BatchedEnv:
    """``n_envs`` copies of ``env`` on ``device``, stepped together."""

    def __init__(
        self,
        env: Env,
        n_envs: int,
        device="cpu",
        fused: bool = False,
        fused_rng: str = "input",
        pallas_physics: bool = False,
    ):
        if pallas_physics:
            raise NotImplementedError(
                "pallas_physics (the physics-only kernel, "
                "rsoccer_tpu/ops/pallas_vss.py) is not ported yet: "
                "ROADMAP.md, TPU kernel queue item K2"
            )
        if fused_rng not in ("input", "kernel"):
            raise ValueError(f"fused_rng must be 'input' or 'kernel', got {fused_rng!r}")
        if fused and type(env) is not VSSEnv:
            raise NotImplementedError(
                f"fused=True is ported for VSSEnv only, not {type(env).__name__}: "
                "ROADMAP.md, TPU kernel queue items K3-K7 (SSL full-step kernels)"
            )
        self.env = env
        self.n_envs = n_envs
        self.device = torch.device(device)
        self.fused = fused
        self.fused_rng = fused_rng
        self.obs_size = env.obs_size
        self.action_size = env.action_size
        self._r_spec = env.reset_noise_spec()
        self._t_spec = env.transition_noise_spec()

    def unpack_state(self, state):
        """Structured view of a ``fused`` packed state."""
        return vss_full.unpack_vss_state(
            state, self.env.n_robots, self.env.field.rbt_wheel_radius
        )

    def reset(self, key):
        """One key for the whole batch; returns (state, obs)."""
        noise = draw_noise(key, self._r_spec, self.n_envs)
        state = self.env.reset_state(noise)
        obs = self.env.observe(state)
        if self.fused:
            return vss_full.pack_vss_state(state), obs
        return state, obs

    def _draw(self, key):
        noise = draw_noise(key, step_noise_spec(self.env), self.n_envs)
        return (
            {k: noise[k] for k in self._t_spec},
            {k: noise[k] for k in self._r_spec},
        )

    def _fused_out(self, st, obs, aux, final: bool):
        reward = aux[0]
        term = aux[1] > 0.5
        trunc = aux[2] > 0.5
        info = {k: aux[3 + i] for i, k in enumerate(_SHAPING_KEYS)}
        if final:
            o = self.obs_size
            return st, obs[:o], obs[o:], reward, term, trunc, info
        return st, obs, reward, term, trunc, info

    def _step(self, state, actions, key, final: bool):
        if self.fused and self.fused_rng == "kernel":
            st, obs, aux = vss_full.vss_full_step(
                self.env, state, actions, key=key, emit_final=final
            )
            return self._fused_out(st, obs, aux, final)
        return self._step_with_noise(state, actions, *self._draw(key), final)

    def _step_with_noise(self, state, actions, t_noise, r_noise, final: bool):
        if self.fused:
            st, obs, aux = vss_full.vss_full_step(
                self.env, state, actions,
                *vss_full.noise_rows(self.env, t_noise, r_noise),
                emit_final=final,
            )
            return self._fused_out(st, obs, aux, final)
        if final:
            return self.env.step_with_noise_final(state, actions, t_noise, r_noise)
        return self.env.step_with_noise(state, actions, t_noise, r_noise)

    def step(self, state, actions, key):
        """Auto-resetting step; actions (A, B), one key (advanced).
        Returns (state, obs, reward, terminated, truncated, info)."""
        return self._step(state, actions, key, final=False)

    def step_final(self, state, actions, key):
        """Like :meth:`step`, plus the final pre-reset obs (gymnasium's
        same-step autoreset convention).  Returns
        (state, obs, final_obs, reward, terminated, truncated, info)."""
        return self._step(state, actions, key, final=True)

    def step_with_noise(self, state, actions, t_noise, r_noise):
        """:meth:`step` with explicit noise dicts (batch-last blocks)."""
        return self._step_with_noise(state, actions, t_noise, r_noise, final=False)

    def step_final_with_noise(self, state, actions, t_noise, r_noise):
        """:meth:`step_final` with explicit noise dicts."""
        return self._step_with_noise(state, actions, t_noise, r_noise, final=True)
