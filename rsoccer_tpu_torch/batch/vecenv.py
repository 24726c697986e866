"""Batched environments.

Port of ``rsoccer_tpu/batch/vecenv.py``.  The env functions already work
on batch-last tensors, so "batching" is the trailing axis itself: state
leaves ``(..., B)``, obs ``(obs_size, B)``, actions ``(action_size, B)``.

Randomness: one key tensor (``ops/philox.make_key``) for the whole batch.
A step draws its reset and transition noise as one Philox draw and
advances the key's step counter in place (``envs/base.draw_noise``).
``env_base`` is the global index of the first env: a batch that is shard
``r`` of ``W`` (``parallel/``) sets it to ``r * n_envs`` and draws, on every
path, the words those columns of the unsharded batch draw.

The envs live on ``device``, the card unless the caller asks for the CPU.

``fused=True`` is the counterpart of the JAX package's ``pallas_full``:
the whole step is one kernel launch (``ops/vss_full.py`` for VSS-v0,
``ops/ssl_full.py`` for the four SSL tasks, chosen by the env's exact
type) on a CUDA device — or its plain version on the CPU — and the state
flows through the rollout packed as one ``(S, B)`` tensor;
:meth:`unpack_state` gives a structured view.  ``fused_rng`` is the
counterpart of ``pallas_rng``: ``"input"`` draws the noise with torch ops
and passes it in as rows, ``"kernel"`` draws it inside the kernel.  Unlike
on the TPU, both read the same Philox stream, so the two modes give the
same trajectory.

``fused_physics=True`` (VSS only) is the counterpart of
``pallas_physics``: the task logic stays in torch ops and the physics is
one kernel launch per step (``ops/vss_physics.py``); the state stays
structured.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from rsoccer_tpu_torch.envs.base import Env, draw_noise, select, step_noise_spec
from rsoccer_tpu_torch.envs.ssl_contested_possession import SSLContestedPossessionEnv
from rsoccer_tpu_torch.envs.ssl_dribbling import SSLDribblingEnv
from rsoccer_tpu_torch.envs.ssl_pass_endurance import SSLPassEnduranceEnv
from rsoccer_tpu_torch.envs.ssl_static_defenders import SSLStaticDefendersEnv
from rsoccer_tpu_torch.envs.vss import VSSEnv
from rsoccer_tpu_torch.ops import ssl_full, vss_full, vss_physics
from rsoccer_tpu_torch.utils import tracing


class FusedOps(NamedTuple):
    """One env type's fused step and the plumbing around it."""

    step: Callable  # (env, state, action, *rows, key=, emit_final=) -> (st, obs, aux)
    rows: Callable  # (env, t_noise, r_noise) -> the kernel's noise rows
    pack: Callable  # structured state -> (S, B)
    unpack: Callable  # (S, B), env -> structured state
    info_keys: tuple  # aux rows 3: in order


_FUSED = {
    VSSEnv: FusedOps(
        vss_full.vss_full_step, vss_full.noise_rows, vss_full.pack_vss_state,
        lambda s, env: vss_full.unpack_vss_state(s, env.n_robots, env.field.rbt_wheel_radius),
        vss_full._SHAPING_KEYS,
    ),
    SSLStaticDefendersEnv: FusedOps(
        ssl_full.sd_full_step, lambda env, t, r: ssl_full.sd_noise_rows(env, r),
        ssl_full.pack_sd_state, ssl_full.unpack_sd_state, ssl_full.SD_KEYS,
    ),
    SSLContestedPossessionEnv: FusedOps(
        ssl_full.cp_full_step, lambda env, t, r: ssl_full.cp_noise_rows(env, r),
        ssl_full.pack_cp_state, ssl_full.unpack_cp_state, ssl_full.CP_KEYS,
    ),
    SSLDribblingEnv: FusedOps(
        ssl_full.dr_full_step, lambda env, t, r: ssl_full.dr_noise_rows(env, r),
        ssl_full.pack_dr_state, ssl_full.unpack_dr_state, ssl_full.DR_KEYS,
    ),
    SSLPassEnduranceEnv: FusedOps(
        ssl_full.pe_full_step, lambda env, t, r: ssl_full.pe_noise_rows(env, r),
        ssl_full.pack_pe_state, ssl_full.unpack_pe_state, ssl_full.PE_KEYS,
    ),
}


def _training_extensions(env) -> bool:
    """Whether ``env`` runs a training-time extension of the JAX package
    (a reset or reward that is not the reference's)."""
    return bool(getattr(env, "curriculum", False) or getattr(env, "terminal_penalty", 0.0)
                or getattr(env, "catch_scale", 1.0) != 1.0 or getattr(env, "aim_shaping", 0.0))


class BatchedEnv:
    """``n_envs`` copies of ``env`` on ``device``, stepped together."""

    def __init__(
        self,
        env: Env,
        n_envs: int,
        device="cuda",
        fused: bool = False,
        fused_rng: str = "input",
        fused_physics: bool = False,
        env_base: int = 0,
    ):
        if fused_rng not in ("input", "kernel"):
            raise ValueError(f"fused_rng must be 'input' or 'kernel', got {fused_rng!r}")
        if fused and fused_physics:
            raise ValueError("fused subsumes fused_physics; pick one")
        if fused_physics and getattr(env, "league", None) != "vss":
            raise NotImplementedError("fused_physics is the VSS physics kernel; VSS envs only")
        if fused and type(env) not in _FUSED:
            raise NotImplementedError(
                f"fused=True is ported for {', '.join(t.__name__ for t in _FUSED)} "
                f"(exact types), not {type(env).__name__}: ROADMAP.md, item 6.3"
            )
        if fused and _training_extensions(env):
            raise ValueError(
                "the fused kernels implement the reference's exact reset and "
                "reward; the training-time extensions (curriculum, "
                "terminal_penalty, catch_scale, aim_shaping) run on the "
                "unfused path (fused=False)"
            )
        self.env = env
        self.n_envs = n_envs
        self.device = torch.device(device)
        self.fused = fused
        self.fused_rng = fused_rng
        self.fused_physics = fused_physics
        self.env_base = env_base
        self._ops = _FUSED[type(env)] if fused else None
        self.obs_size = env.obs_size
        self.action_size = env.action_size
        self._r_spec = env.reset_noise_spec()
        self._t_spec = env.transition_noise_spec()

    def unpack_state(self, state):
        """Structured view of a ``fused`` packed state."""
        return self._ops.unpack(state, self.env)

    def reset(self, key):
        """One key for the whole batch, on ``device``; returns (state, obs).
        The set-up phase ``rsoccer.setup.reset`` (``utils/tracing``)."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchedEnv is on 'cuda' (the default) but no CUDA device is "
                "available; pass device='cpu' to run the plain versions on the CPU"
            )
        if key.device.type != self.device.type:
            raise ValueError(f"key is on {key.device}, the envs on {self.device}")
        with tracing.phase(tracing.SETUP_RESET):
            return self.reset_with_noise(draw_noise(key, self._r_spec, self.n_envs, self.env_base))

    def reset_with_noise(self, noise):
        """:meth:`reset` from an explicit reset-noise dict (batch-last
        blocks)."""
        state = self.env.reset_state(noise)
        obs = self.env.observe(state)
        if self.fused:
            return self._ops.pack(state), obs
        return state, obs

    def _draw(self, key):
        """The step's (transition, reset) noise: one draw, split by spec.  A
        reset that draws nothing (Dribbling's) gets the pad block an empty
        spec draws, from which it takes its batch."""
        noise = draw_noise(key, step_noise_spec(self.env), self.n_envs, self.env_base)
        t_noise = {k: noise[k] for k in self._t_spec}
        if not self._r_spec:
            return t_noise, {"_pad": torch.zeros((1, self.n_envs), device=key.device)}
        return t_noise, {k: noise[k] for k in self._r_spec}

    def _fused_out(self, st, obs, aux, final: bool):
        reward = aux[0]
        term = aux[1] > 0.5
        trunc = aux[2] > 0.5
        info = {k: aux[3 + i] for i, k in enumerate(self._ops.info_keys)}
        if final:
            o = self.obs_size
            return st, obs[:o], obs[o:], reward, term, trunc, info
        return st, obs, reward, term, trunc, info

    def _step(self, state, actions, key, final: bool):
        with tracing.span(tracing.ENV_STEP):
            if self.fused and self.fused_rng == "kernel":
                with tracing.span(tracing.ENV_KERNEL):
                    st, obs, aux = self._ops.step(
                        self.env, state, actions, key=key, emit_final=final, env_base=self.env_base
                    )
                return self._fused_out(st, obs, aux, final)
            return self._step_with_noise(state, actions, *self._draw(key), final)

    def _step_with_noise(self, state, actions, t_noise, r_noise, final: bool):
        if self.fused:
            with tracing.span(tracing.ENV_KERNEL):
                st, obs, aux = self._ops.step(
                    self.env, state, actions,
                    *self._ops.rows(self.env, t_noise, r_noise),
                    emit_final=final,
                )
            return self._fused_out(st, obs, aux, final)
        if self.fused_physics:
            return self._physics_step(state, actions, t_noise, r_noise, final)
        if final:
            return self.env.step_with_noise_final(state, actions, t_noise, r_noise)
        return self.env.step_with_noise(state, actions, t_noise, r_noise)

    def _physics_step(self, state, actions, t_noise, r_noise, final: bool):
        """pre-physics (torch) -> the physics kernel -> post-physics (torch)
        -> truncation and auto-reset select: the env's step_with_noise[_final]
        with its physics through ``ops/vss_physics``."""
        env = self.env
        commands, aux = env.pre_physics(state, actions, t_noise)
        world = vss_physics.world_step(env, state.world, commands)
        ns, reward, term, info = env.post_physics(state, world, aux)
        trunc = ns.steps >= env.max_episode_steps
        out = select(term | trunc, env.reset_state(r_noise), ns)
        final_obs = (env.observe(ns),) if final else ()
        return (out, env.observe(out), *final_obs, reward, term, trunc, info)

    def step(self, state, actions, key):
        """Auto-resetting step; actions (A, B), one key (advanced).
        Returns (state, obs, reward, terminated, truncated, info)."""
        return self._step(state, actions, key, final=False)

    @property
    def supports_step_final(self) -> bool:
        """Whether :meth:`step_final` is available on this path: on every
        path (the fused kernels' ``emit_final`` variant, the physics kernel
        and the unfused env step)."""
        return True

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
