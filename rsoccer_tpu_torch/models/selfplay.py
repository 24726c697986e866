"""Self-play: a frozen opponent drives the yellow team.

Port of ``rsoccer_tpu/models/selfplay.py``.  :class:`SelfPlayBatchedEnv`
turns the both-teams env :class:`~rsoccer_tpu_torch.envs.vss_selfplay.VSSSelfPlayEnv`
back into the blue-only interface the learners expect: the learner gives
the blue actions, and the yellow actions come from a frozen policy on the
MIRRORED observation (the field rotated 180 degrees, teams swapped), so
one "blue attacking +x" network plays both sides.

The opponent's parameters and the obs-normaliser statistics it trained
under travel inside the env state as an :class:`OpponentPayload` of
tensors, so a swap is a data operation between train steps, and a PPO
training state that carries the payload saves and resumes with it
(``PPOTrainer.state_tree``)::

    benv = SelfPlayBatchedEnv(env, n_envs, init_net, device="cuda", fused_physics=True)
    trainer = PPOTrainer(benv, cfg)
    state = trainer.init(seed)
    ...
    state = benv.swap_opponent(state, benv.payload_from(state.net, state.obs_norm))
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import functional_call

from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.envs import ou
from rsoccer_tpu_torch.envs.vss_selfplay import VSSSelfPlayEnv
from rsoccer_tpu_torch.ops.philox import box_muller, philox_words, uniforms_from_words

# The OU lanes' normals come from the batch's Philox key at the step's own
# counter, from this block of each env's stream up: the env step draws its
# reset blocks from block 0 and never gets near it.
OU_LANES_BLOCK = 1 << 31


class OpponentPayload(NamedTuple):
    params: dict  # {parameter name of ActorCritic: tensor}, a copy
    norm_mean: torch.Tensor  # (O,) the obs-normaliser the snapshot trained under
    norm_var: torch.Tensor  # (O,)


def _copy(payload: OpponentPayload) -> OpponentPayload:
    return OpponentPayload(
        {k: v.detach().clone() for k, v in payload.params.items()},
        payload.norm_mean.detach().clone(), payload.norm_var.detach().clone(),
    )


class SelfPlayBatchedEnv:
    """A ``BatchedEnv``-compatible adapter whose state is ``(inner_state,
    OpponentPayload)`` and whose actions are the blue team's
    ``(action_size // 2, B)``.

    ``net`` (an :class:`~rsoccer_tpu_torch.models.networks.ActorCritic`
    of the learner's shape and compute dtype) is the function the
    opponent's parameters run through; its parameters at construction are
    the first opponent (copied).  ``ou_lanes``: the first K lanes play the
    reference opponent distribution instead of the frozen policy: their
    yellow robots are driven by VSS-v0's Ornstein-Uhlenbeck process
    (vss_gym.py:127-140), advanced on the env state's ``ou_x``, which
    self-play otherwise carries unused.  ``device`` and ``fused_physics``
    go to the inner :class:`BatchedEnv` (the fused whole-step kernels take
    only the exact env types: VSS-v0's, not this one).
    """

    def __init__(self, env: VSSSelfPlayEnv, n_envs: int, net, ou_lanes: int = 0,
                 device="cuda", fused_physics: bool = False):
        if not 0 <= ou_lanes <= n_envs:
            raise ValueError(f"ou_lanes={ou_lanes} not in [0, {n_envs}]")
        self.benv = BatchedEnv(env, n_envs, device=device, fused_physics=fused_physics)
        self.env = env
        self.n_envs = n_envs
        self.device = self.benv.device
        self.obs_size = env.obs_size
        self.action_size = env.action_size // 2  # the learner drives blue only
        self.net = net
        self.ou_lanes = ou_lanes
        self._is_ou = (torch.arange(n_envs, device=self.device) < ou_lanes)[None, :]
        self._init_payload = self.payload_from(net)

    def reset(self, key):
        state, obs = self.benv.reset(key)
        return (state, _copy(self._init_payload)), obs

    # ------------------------------------------------------------- opponent
    def ou_normals(self, key) -> torch.Tensor:
        """The OU lanes' standard normals ``(n_robots, 2, B)`` at ``key``'s
        step, from ``OU_LANES_BLOCK`` (Box-Muller, all ``u1`` first, as
        ``envs/base.draw_noise``).  Does not advance the key."""
        n = 2 * self.env.n_robots
        u = uniforms_from_words(philox_words(key, 2 * n, self.n_envs, OU_LANES_BLOCK))
        return box_muller(u[:n], u[n:]).reshape(self.env.n_robots, 2, self.n_envs)

    def _yellow_actions(self, inner, opp: OpponentPayload, ou_noise):
        """The frozen policy's yellow actions, the first ``ou_lanes`` lanes
        overridden by the OU process (advanced on every lane's ``ou_x``,
        from ``ou_noise``).  Returns (inner, yellow (action_size, B))."""
        obs = self.env.observe_opponent(inner)  # (O, B), the mirrored view
        # the normalisation the snapshot trained under (ObsNorm.normalize)
        o = torch.clamp((obs.T - opp.norm_mean) / torch.sqrt(opp.norm_var + 1e-8), -10.0, 10.0)
        with torch.no_grad():
            mean, _, _ = functional_call(self.net, opp.params, (o,))
        # deterministic opponent, clipped to the Box(-1, 1) action space
        yellow = torch.clamp(mean.T, -1.0, 1.0)
        if self.ou_lanes:
            if ou_noise is None:
                raise ValueError("ou_lanes > 0: the OU lanes' normals are an input of this step")
            ou_x = ou.ou_update(inner.ou_x, ou_noise, self.env.time_step)
            inner = inner._replace(ou_x=ou_x)
            # the yellow rows of the (n_robots, 2, B) process in the (A, B)
            # action layout (robot-major), unclipped, as VSS-v0 feeds OU
            yellow_ou = ou_x[self.env.n_blue:].reshape(self.action_size, -1)
            yellow = torch.where(self._is_ou, yellow_ou, yellow)
        return inner, yellow.contiguous()

    def _full(self, state, blue_actions, ou_noise):
        inner, opp = state
        inner, yellow = self._yellow_actions(inner, opp, ou_noise)
        return inner, opp, torch.cat([blue_actions, yellow], dim=0)

    def _key_noise(self, key):
        return self.ou_normals(key) if self.ou_lanes else None

    # ----------------------------------------------------------------- step
    def step(self, state, blue_actions, key):
        """Auto-resetting step; blue actions ``(action_size, B)``, one key
        (advanced).  Returns (state, obs, reward, terminated, truncated,
        info)."""
        inner, opp, full = self._full(state, blue_actions, self._key_noise(key))
        out = self.benv.step(inner, full, key)
        return ((out[0], opp), *out[1:])

    @property
    def supports_step_final(self) -> bool:
        return self.benv.supports_step_final

    def step_final(self, state, blue_actions, key):
        """Like :meth:`step`, plus the final pre-reset obs (PPO bootstraps
        truncated lanes from its value)."""
        inner, opp, full = self._full(state, blue_actions, self._key_noise(key))
        out = self.benv.step_final(inner, full, key)
        return ((out[0], opp), *out[1:])

    def step_with_noise(self, state, blue_actions, t_noise, r_noise, ou_noise=None):
        """:meth:`step` with explicit noise: the env's blocks and the OU
        lanes' normals ``(n_robots, 2, B)``."""
        inner, opp, full = self._full(state, blue_actions, ou_noise)
        out = self.benv.step_with_noise(inner, full, t_noise, r_noise)
        return ((out[0], opp), *out[1:])

    def step_final_with_noise(self, state, blue_actions, t_noise, r_noise, ou_noise=None):
        """:meth:`step_final` with explicit noise (``PPOTrainer._rollout``'s
        draws: ``(t_noise, r_noise, ou_noise)`` per step)."""
        inner, opp, full = self._full(state, blue_actions, ou_noise)
        out = self.benv.step_final_with_noise(inner, full, t_noise, r_noise)
        return ((out[0], opp), *out[1:])

    # ------------------------------------------------------------ opponents
    def payload_from(self, net, obs_norm=None) -> OpponentPayload:
        """A snapshot of ``net``'s parameters (and of ``obs_norm``'s mean
        and var, else the identity normaliser), copied: never an alias of
        the learner's tensors, which its optimiser steps in place."""
        params = {k: v.detach().clone() for k, v in net.named_parameters()}
        if obs_norm is None:
            return OpponentPayload(params, torch.zeros((self.obs_size,), device=self.device),
                                   torch.ones((self.obs_size,), device=self.device))
        return OpponentPayload(params, obs_norm.mean.detach().clone(), obs_norm.var.detach().clone())

    @staticmethod
    def swap_opponent(train_state, payload: OpponentPayload):
        """A PPO ``TrainState`` with a copy of ``payload`` as its frozen
        opponent."""
        inner, _old = train_state.env_state
        return train_state._replace(env_state=(inner, _copy(payload)))
