"""Soft Actor-Critic with a replay ring on the env's device.

Port of ``rsoccer_tpu/models/sac.py``.  One :meth:`SACTrainer.train_step`
is one SAC iteration: ``env_steps_per_iter`` batched env steps through
``BatchedEnv.step_final`` (on the fused path, the env kernel's
``emit_final`` variant), each inserted into the replay ring, then
``grad_steps_per_iter`` updates of the twin critics, the actor and the
temperature on n-step targets, with a polyak step of the target critics.
The JAX package compiles the iteration into one program; here it is a
Python loop of launches on the env's device with no host sync inside it.

The networks are flax's, rounding points included: the towers compute in
``compute_dtype`` (a flax ``Dense(dtype=...)`` casts input, kernel and
bias, multiplies to a result of that dtype and adds the bias in it), the
``mean``, ``log_std`` and ``q`` heads take the tower's output cast to f32.
The twin critics are one module whose weights carry a leading axis of 2,
so both critics run in one batched matmul per layer and one Adam serves
both: the q loss is the sum of the two per-critic means, so each slice's
gradient is its own critic's.

Randomness comes from explicit streams: the env noise from the batch's
Philox key (``SACState.env_key``), everything else from the
``torch.Generator`` that the caller hands to :meth:`SACTrainer.train_step`
(:func:`iteration_generator` gives one per iteration).  ``_collect`` and
``_update`` take their draws as arguments (:class:`CollectDraws`,
:class:`UpdateDraws`), so a test can feed the JAX package's.

With ``mesh`` (``parallel/mesh.EnvMesh``) the trainer is one rank's half
of a data-parallel SAC (``parallel/sac.py``, the counterpart of the JAX
trainer's ``axis_name``): each of the three gradients is averaged over
the ranks before its optimiser steps, so the replicated networks, which
:meth:`SACTrainer.init` takes from the mesh's first rank, stay
bit-identical on every rank.

Two departures from the JAX package, both deliberate:

- ``actor_freeze_iters`` counts iterations of :meth:`train_step`; the JAX
  package compares it with the count of collect calls, which runs
  ``env_steps_per_iter`` times faster.  At ``env_steps_per_iter == 1`` the
  two agree.
- :class:`Buffer` records its insert width at the first insert and refuses
  any other; the JAX package's contiguous insert assumes one fixed width
  without checking it (a different width clamps at the ring's end instead
  of wrapping).
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.models.networks import check_device
from rsoccer_tpu_torch.models.ppo import PhaseClock
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.parallel.mesh import EnvMesh, all_reduce_grads, broadcast_params

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
# flax's lecun_normal: a normal cut at +-2 sigma, rescaled by this to keep
# the variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class SACConfig(NamedTuple):
    buffer_size: int = 1 << 18
    batch_size: int = 256
    env_steps_per_iter: int = 1  # batched env steps per train iteration
    grad_steps_per_iter: int = 1
    gamma: float = 0.99
    tau: float = 0.005  # polyak rate
    lr: float = 3e-4
    compute_dtype: torch.dtype = torch.float32  # the towers' dtype; the heads stay f32
    # keep the actor (and temperature) frozen for the first N ITERATIONS of
    # train_step while the critics fit: a BC-cloned actor would otherwise
    # be shredded by gradients from still-random critics
    actor_freeze_iters: int = 0
    init_alpha: float = 0.1
    target_entropy_scale: float = 1.0  # target entropy = -scale * act_dim
    warmup_steps: int = 1000  # collect calls with uniform-random actions
    reward_scale: float = 1.0  # Q-target scale of the n-step return
    # n-step Q targets.  One batched step inserts all B envs contiguously,
    # so env b's next transition sits exactly B slots later in the ring:
    # a chain is a strided gather.  Chains stop at episode ends (terminated
    # or truncated) and bootstrap from the last chained next_obs; n_step=1
    # is classic SAC.
    n_step: int = 1
    hidden: tuple = (256, 256)  # actor and critic tower widths


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class SquashedGaussianActor(nn.Module):
    """``forward(obs (B, O)) -> (mean (B, A), log_std (B, A))``, log_std
    clipped to [-5, 2]; the action is ``tanh`` of a Gaussian sample
    (:func:`sample_squashed`).  flax ``Dense`` init (lecun normal kernels,
    zero biases) drawn on the CPU from ``gen`` (default: seeded 0), then
    moved to ``device``."""

    def __init__(
        self,
        obs_size: int,
        action_size: int,
        hidden: Sequence[int] = (256, 256),
        compute_dtype: torch.dtype = torch.float32,
        device="cuda",
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        device = check_device(device)
        self.obs_size = obs_size
        self.action_size = action_size
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        widths = (obs_size, *self.hidden)

        def dense(n_in, n_out):
            layer = nn.Linear(n_in, n_out)
            with torch.no_grad():
                _lecun_normal_(layer.weight, n_in, gen)
                layer.bias.zero_()
            return layer

        self.tower = nn.ModuleList(dense(i, o) for i, o in zip(widths, widths[1:]))
        self.mean = dense(widths[-1], action_size)
        self.log_std = dense(widths[-1], action_size)
        self.to(device)

    def forward(self, obs):
        dt = self.compute_dtype
        x = obs.to(dt)
        for layer in self.tower:
            x = torch.relu(F.linear(x, layer.weight.to(dt)) + layer.bias.to(dt))
        x = x.float()
        return self.mean(x), torch.clamp(self.log_std(x), -5.0, 2.0)


class TwinQCritic(nn.Module):
    """The twin Q critics as one module: ``forward(obs (B, O), action
    (B, A)) -> q (2, B)``.  Layer ``l``'s kernel is ``(2, in, out)`` (flax's
    ``(in, out)`` per critic) and its bias ``(2, out)``; both critics run
    in one batched matmul per layer.  Each critic is drawn as flax draws
    one ``QCritic`` (lecun-normal kernels, zero biases), on the CPU from
    ``gen`` (default: seeded 0)."""

    def __init__(
        self,
        obs_size: int,
        action_size: int,
        hidden: Sequence[int] = (256, 256),
        compute_dtype: torch.dtype = torch.float32,
        device="cuda",
        gen: torch.Generator | None = None,
    ):
        super().__init__()
        device = check_device(device)
        self.obs_size = obs_size
        self.action_size = action_size
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        widths = (obs_size + action_size, *self.hidden, 1)
        kernels = [torch.empty((2, i, o)) for i, o in zip(widths, widths[1:])]
        for c in range(2):  # critic by critic, layer by layer: two flax inits
            for w in kernels:
                _lecun_normal_(w[c], w.shape[1], gen)
        self.kernels = nn.ParameterList(nn.Parameter(w) for w in kernels)
        self.biases = nn.ParameterList(nn.Parameter(torch.zeros((2, o))) for o in widths[1:])
        self.to(device)

    @staticmethod
    def _dense(x, w, b, dt):
        """(B, in) or (2, B, in) -> (2, B, out) in dtype ``dt``."""
        w, b = w.to(dt), b.to(dt)[:, None, :]
        if x.dim() == 2:
            x = x.expand(2, *x.shape)
        if dt == torch.float32:
            return torch.baddbmm(b, x, w)
        return torch.bmm(x, w) + b  # flax rounds the product before the bias add

    def forward(self, obs, action):
        dt = self.compute_dtype
        x = torch.cat([obs, action], dim=-1).to(dt)
        n = len(self.hidden)
        for w, b in zip(list(self.kernels)[:n], list(self.biases)[:n]):
            x = torch.relu(self._dense(x, w, b, dt))
        return self._dense(x.float(), self.kernels[n], self.biases[n], torch.float32)[..., 0]


def sample_squashed(mean, log_std, eps):
    """tanh-squashed Gaussian sample and its log-prob with the tanh
    correction: (mean, log_std, eps (B, A) standard normals) -> (action
    (B, A), logp (B,))."""
    std = torch.exp(log_std)
    z = mean + std * eps
    a = torch.tanh(z)
    logp = torch.sum(-0.5 * ((z - mean) / std) ** 2 - log_std - _HALF_LOG_2PI, dim=-1)
    logp = logp - torch.sum(torch.log(1.0 - a**2 + 1e-6), dim=-1)
    return a, logp


class Buffer:
    """The replay ring on one device: ``obs`` (C, O), ``action`` (C, A),
    ``rdb`` (C, 3) = [reward, done, boundary] (done: terminated;
    boundary: the episode ended, terminated or truncated, so the next slot
    of that env starts a fresh episode), ``next_obs`` (C, O).  ``ptr``,
    ``filled`` and the insert ``width`` are host ints: every insert has the
    batch's width, so they never need the device.  Inserts are in place."""

    R, D, B = 0, 1, 2

    def __init__(self, capacity: int, obs_size: int, action_size: int, device="cuda"):
        device = check_device(device)
        self.obs = torch.zeros((capacity, obs_size), device=device)
        self.action = torch.zeros((capacity, action_size), device=device)
        self.rdb = torch.zeros((capacity, 3), device=device)
        self.next_obs = torch.zeros((capacity, obs_size), device=device)
        self.ptr = 0
        self.filled = 0
        self.width = None  # the insert width, fixed by the first insert
        self._consts = {}

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    @property
    def device(self) -> torch.device:
        return self.obs.device

    def add_batch(self, obs, action, reward, next_obs, done, boundary):
        """Insert ``b`` transitions (rows ``(b, ...)``) at ``ptr``.  When
        ``b`` divides the capacity the block never wraps and each array
        takes one slice copy; otherwise a modular scatter.  Raises if ``b``
        is not the width of the first insert."""
        b, c = obs.shape[0], self.capacity
        if self.width is None:
            self.width = b
        elif b != self.width:
            raise ValueError(
                f"insert width {b} differs from the ring's insert width {self.width}: "
                "the n-step chains stride by one fixed width"
            )
        rdb = torch.stack([reward, done, boundary], dim=-1)
        if c % b == 0:
            blk = slice(self.ptr, self.ptr + b)
            for arr, val in ((self.obs, obs), (self.action, action), (self.rdb, rdb),
                             (self.next_obs, next_obs)):
                arr[blk] = val
        else:
            idx = torch.remainder(self.ptr + torch.arange(b, device=self.device), c)
            for arr, val in ((self.obs, obs), (self.action, action), (self.rdb, rdb),
                             (self.next_obs, next_obs)):
                arr.index_copy_(0, idx, val.to(arr.dtype))
        self.ptr = (self.ptr + b) % c
        self.filled = min(self.filled + b, c)

    def sample(self, idx):
        """One-step sample at slots ``idx`` (drawn in [0, max(filled, 1))):
        (obs, action, reward, next_obs, done)."""
        rdb = self.rdb[idx]
        return self.obs[idx], self.action[idx], rdb[:, Buffer.R], self.next_obs[idx], rdb[:, Buffer.D]

    def nstep_window(self, stride: int, n_step: int) -> int:
        """How many chain starts hold all ``n_step`` links: offsets from the
        oldest element are drawn in [0, this)."""
        return max(self.filled - (n_step - 1) * stride, 1)

    def _chain_consts(self, stride: int, n_step: int, gamma: float):
        k = (stride, n_step, gamma)
        if k not in self._consts:
            ks = torch.arange(n_step, device=self.device)
            # the powers in f64, then cast once, as the JAX package does
            gammas = torch.tensor(np.power(float(gamma), np.arange(n_step + 1)),
                                  dtype=torch.float32).to(self.device)
            is_last = (ks == n_step - 1)[:, None]
            self._consts[k] = (ks[:, None] * stride, (ks[:, None] + 1) * stride, is_last, gammas)
        return self._consts[k]

    def sample_nstep(self, off, stride: int, n_step: int, gamma: float):
        """n-step transitions at offsets ``off`` (batch,) from the oldest
        element, drawn in [0, :meth:`nstep_window`): ``(obs, action, G,
        boot_obs, boot_disc)``.  ``G = sum_k gamma^k r_k`` over the chain up
        to its first episode end (inclusive) or ``n_step`` links;
        ``boot_disc = gamma^(m+1) (1 - done_last)`` at the chain's last link
        ``m``, whose next_obs is ``boot_obs``.  A link whose successor is
        not written yet (early filling) ends the chain too; the last link
        ``n_step - 1`` never counts as unwritten.  ``stride`` is the insert
        width: env b's next transition lies ``stride`` slots later."""
        c = self.capacity
        link, ahead, is_last, gammas = self._chain_consts(stride, n_step, gamma)
        start = (self.ptr - self.filled) % c  # the oldest element
        base = torch.remainder(start + off, c)
        pos = torch.remainder(base[None, :] + link, c)  # (n, batch)
        rdb = self.rdb[pos]  # (n, batch, 3): one row gather for all scalars
        r, bnd = rdb[..., Buffer.R], rdb[..., Buffer.B]
        unwritten = ((off[None, :] + ahead) >= self.filled) & ~is_last
        kill = torch.maximum(bnd, unwritten.to(bnd.dtype))
        alive = torch.cat([torch.ones_like(kill[:1]), torch.cumprod(1.0 - kill, dim=0)[:-1]])
        g = torch.sum(alive * gammas[:n_step, None] * r, dim=0)
        stop = (bnd > 0.0) | unwritten | is_last
        last = torch.argmax(((alive > 0.0) & stop).to(torch.uint8), dim=0)  # the first chain end
        pos_last = pos.gather(0, last[None])[0]
        done_last = rdb[..., Buffer.D].gather(0, last[None])[0]
        boot_disc = gammas[last + 1] * (1.0 - done_last)
        return self.obs[base], self.action[base], g, self.next_obs[pos_last], boot_disc


class SACState(NamedTuple):
    actor: SquashedGaussianActor
    qs: TwinQCritic
    qs_target: TwinQCritic
    log_alpha: torch.Tensor  # () f32 leaf, requires grad
    opt_actor: torch.optim.Adam
    opt_qs: torch.optim.Adam
    opt_alpha: torch.optim.Adam
    buffer: Buffer
    env_state: object  # batched env state (batch-last leaves, or packed (S, B))
    obs: torch.Tensor  # (O, B)
    env_key: torch.Tensor  # the batch's Philox key (advanced by every step)
    total_steps: int  # collect calls so far (the warmup's unit)
    iteration: int  # train_step calls so far (the actor freeze's unit)


class CollectDraws(NamedTuple):
    """One collect's draws: the policy's standard normals (B, A) (None
    during warmup), the uniform warmup actions in [-1, 1) (B, A) (None
    after it), and the env's ``(t_noise, r_noise)`` dicts in place of the
    state's key (None: the key draws them)."""

    normal: torch.Tensor | None
    uniform: torch.Tensor | None
    env: tuple | None = None


class UpdateDraws(NamedTuple):
    """One update's draws: the chain offsets (batch,) in [0,
    ``Buffer.nstep_window``), the normals of the target's next action and
    of the actor loss's action (batch, A)."""

    offsets: torch.Tensor
    next_eps: torch.Tensor
    pi_eps: torch.Tensor


def iteration_generator(seed: int, iteration: int, device="cuda", rank: int = 0) -> torch.Generator:
    """The draws of iteration ``iteration`` of a run seeded ``seed``: a
    generator seeded by ``(seed + 1, iteration)`` (the JAX package's
    ``fold_in(PRNGKey(seed + 1), i)``), so a resumed run draws what an
    uninterrupted one would.  ``rank``: rank ``rank``'s stream of a sharded
    run (``parallel/sac.py``; the JAX package's ``fold_in(key, idx)``): the
    seed XORed with ``rank`` times an odd 64-bit constant, so rank 0 draws
    the unsharded stream."""
    s = (((seed + 1) & 0xFFFFFFFF) << 32) | (iteration & 0xFFFFFFFF)
    s ^= (rank * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    return torch.Generator(device=device).manual_seed(s)


def make_policy(actor: SquashedGaussianActor, deterministic: bool = True):
    """Lane-layout policy ``policy(gen, obs (O, B)) -> actions (A, B)`` for
    ``batch/rollout`` and ``eval``: ``tanh(mean)``, or a squashed sample
    drawn from ``gen``."""

    def policy(gen, obs):
        with torch.no_grad():
            mean, log_std = actor(obs.T)
            if deterministic:
                return torch.tanh(mean).T.contiguous()
            eps = torch.randn(mean.shape, generator=gen, device=mean.device)
            a, _ = sample_squashed(mean, log_std, eps)
            return a.T.contiguous()

    return policy


class SACTrainer:
    def __init__(self, benv: BatchedEnv, config: SACConfig = SACConfig(), mesh: EnvMesh | None = None):
        """``mesh``: this trainer runs one rank's shard (``benv``, ``config``
        already cut to the rank's envs, ring and minibatch;
        ``parallel/sac.make_sharded_sac`` builds it) and averages each
        gradient over the mesh before its step.  None: single-device."""
        self.benv = benv
        self.cfg = config
        self.mesh = mesh
        self.device = check_device(benv.device)
        self.target_entropy = -config.target_entropy_scale * benv.action_size
        # n-step chains walk n_step links of stride n_envs through the ring;
        # with buffer_size <= (n_step - 1) * n_envs the window clamps to 1 and
        # every sample is the oldest transition: refuse
        if config.buffer_size < config.n_step * benv.n_envs:
            raise ValueError(
                f"buffer_size ({config.buffer_size}) must be >= "
                f"n_step * n_envs ({config.n_step} * {benv.n_envs} = "
                f"{config.n_step * benv.n_envs}) for strided n-step chains"
            )
        self._clock = None

    # ------------------------------------------------------------------
    def make_optimizer(self, params) -> torch.optim.Adam:
        """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside
        the square root)."""
        return torch.optim.Adam(params, lr=self.cfg.lr, eps=1e-8)

    def init(self, seed: int) -> SACState:
        cfg, benv, dev = self.cfg, self.benv, self.device
        gen = torch.Generator().manual_seed(seed)
        kw = dict(hidden=cfg.hidden, compute_dtype=cfg.compute_dtype, device=dev, gen=gen)
        actor = SquashedGaussianActor(benv.obs_size, benv.action_size, **kw)
        qs = TwinQCritic(benv.obs_size, benv.action_size, **kw)
        if self.mesh is not None:  # every rank starts from the first rank's networks
            broadcast_params([*actor.parameters(), *qs.parameters()], self.mesh)
        key = make_key(seed, stream=1, device=dev)
        env_state, obs = benv.reset(key)
        log_alpha = torch.log(torch.tensor(cfg.init_alpha, dtype=torch.float32)).to(dev)
        log_alpha.requires_grad_(True)
        return SACState(
            actor=actor,
            qs=qs,
            qs_target=copy.deepcopy(qs),
            log_alpha=log_alpha,
            opt_actor=self.make_optimizer(actor.parameters()),
            opt_qs=self.make_optimizer(qs.parameters()),
            opt_alpha=self.make_optimizer([log_alpha]),
            buffer=Buffer(cfg.buffer_size, benv.obs_size, benv.action_size, dev),
            env_state=env_state,
            obs=obs,
            env_key=key,
            total_steps=0,
            iteration=0,
        )

    # ------------------------------------------------------------------
    def collect_draws(self, state: SACState, gen: torch.Generator) -> CollectDraws:
        shape = (self.benv.n_envs, self.benv.action_size)
        if state.total_steps < self.cfg.warmup_steps:
            u = torch.rand(shape, generator=gen, device=self.device) * 2.0 - 1.0
            return CollectDraws(normal=None, uniform=u)
        return CollectDraws(normal=torch.randn(shape, generator=gen, device=self.device), uniform=None)

    def _collect(self, state: SACState, draws: CollectDraws):
        """One batched env step, inserted into the ring.  Returns (state,
        reward (B,))."""
        obs_bf = state.obs.T  # (B, O)
        with torch.no_grad():
            if state.total_steps < self.cfg.warmup_steps:
                action = draws.uniform
            else:
                mean, log_std = state.actor(obs_bf)
                action, _ = sample_squashed(mean, log_std, draws.normal)
            act = action.T.contiguous()
            # the true successor obs (pre-reset on episode ends): truncated
            # transitions bootstrap from the episode's final obs
            if draws.env is None:
                env_state, next_obs, final_obs, reward, term, trunc, _ = self.benv.step_final(
                    state.env_state, act, state.env_key)
            else:
                env_state, next_obs, final_obs, reward, term, trunc, _ = (
                    self.benv.step_final_with_noise(state.env_state, act, *draws.env))
            state.buffer.add_batch(
                obs_bf, action, reward, final_obs.T, term.to(torch.float32),
                (term | trunc).to(torch.float32),
            )
        return state._replace(env_state=env_state, obs=next_obs,
                              total_steps=state.total_steps + 1), reward

    def update_draws(self, state: SACState, gen: torch.Generator) -> UpdateDraws:
        cfg, dev = self.cfg, self.device
        valid = state.buffer.nstep_window(self.benv.n_envs, cfg.n_step)
        shape = (cfg.batch_size, self.benv.action_size)
        return UpdateDraws(
            offsets=torch.randint(0, valid, (cfg.batch_size,), generator=gen, device=dev),
            next_eps=torch.randn(shape, generator=gen, device=dev),
            pi_eps=torch.randn(shape, generator=gen, device=dev),
        )

    def actor_frozen(self, state: SACState) -> bool:
        """Whether this iteration holds the actor and temperature: the first
        ``actor_freeze_iters`` iterations of :meth:`train_step`."""
        return state.iteration < self.cfg.actor_freeze_iters

    def _pmean_grads(self, params):
        """On a mesh, each gradient averaged over the ranks (one all_reduce
        of the flattened gradients): every rank's minibatch is the same
        size, so the mean of the per-rank mean-loss gradients is the
        gradient of the global minibatch's mean loss."""
        if self.mesh is not None:
            all_reduce_grads(params, self.mesh, average=True)

    def _update(self, state: SACState, draws: UpdateDraws):
        """One update of critics, actor and temperature, then the polyak
        step, in the JAX package's order.  Steps the modules and optimisers
        in place; returns (state, metrics as device scalars)."""
        cfg = self.cfg
        actor, qs = state.actor, state.qs
        obs, action, g, boot_obs, boot_disc = state.buffer.sample_nstep(
            draws.offsets, self.benv.n_envs, cfg.n_step, cfg.gamma)
        alpha = torch.exp(state.log_alpha.detach())

        # targets: G_n + gamma^m (1 - done) V(boot_obs), with the target
        # critics and the current (pre-update) temperature
        with torch.no_grad():
            n_mean, n_log_std = actor(boot_obs)
            next_a, next_logp = sample_squashed(n_mean, n_log_std, draws.next_eps)
            tq = state.qs_target(boot_obs, next_a)
            target_v = torch.min(tq, dim=0).values - alpha * next_logp
            target_q = cfg.reward_scale * g + boot_disc * target_v

        def q_loss():
            q = qs(obs, action)
            # the SUM of the two per-critic mean losses: each slice's grad
            # is its own critic's
            return torch.sum(torch.mean((q - target_q[None, :]) ** 2, dim=1))

        state.opt_qs.zero_grad(set_to_none=False)
        q_loss().backward()
        self._pmean_grads(qs.parameters())
        state.opt_qs.step()

        # the actor loss against the UPDATED critics (no gradient into them)
        frozen = self.actor_frozen(state)
        qs.requires_grad_(False)
        try:
            with torch.set_grad_enabled(not frozen):  # frozen: the loss is only a metric
                mean, log_std = actor(obs)
                a, logp = sample_squashed(mean, log_std, draws.pi_eps)
                a_loss = torch.mean(alpha * logp - torch.min(qs(obs, a), dim=0).values)
            if not frozen:  # a frozen actor keeps its params and Adam state
                state.opt_actor.zero_grad(set_to_none=False)
                a_loss.backward()
                self._pmean_grads(actor.parameters())
                state.opt_actor.step()
        finally:
            qs.requires_grad_(True)
        if not frozen:
            alpha_loss = -torch.mean(torch.exp(state.log_alpha)
                                     * (logp.detach() + self.target_entropy))
            state.opt_alpha.zero_grad(set_to_none=False)
            alpha_loss.backward()
            self._pmean_grads([state.log_alpha])
            state.opt_alpha.step()

        with torch.no_grad():
            targets = list(state.qs_target.parameters())
            torch._foreach_mul_(targets, 1.0 - cfg.tau)
            torch._foreach_add_(targets, list(qs.parameters()), alpha=cfg.tau)
            metrics = {
                # halved: the per-critic MSE scale
                "q_loss": q_loss() * 0.5,
                "actor_loss": a_loss.detach(),
                "alpha": torch.exp(state.log_alpha.detach()),
            }
        return state, metrics

    # ------------------------------------------------------------------
    def train_step(self, state: SACState, gen: torch.Generator):
        """One iteration: ``env_steps_per_iter`` collects, then
        ``grad_steps_per_iter`` updates, every draw but the env's from
        ``gen``.  Steps the modules and optimisers in place; returns (the
        new SACState, metrics as device scalars: mean_reward, q_loss,
        actor_loss, alpha)."""
        cfg = self.cfg
        clock = PhaseClock(self.device)
        clock.mark()
        rews = torch.zeros((), device=self.device)
        for _ in range(cfg.env_steps_per_iter):
            state, r = self._collect(state, self.collect_draws(state, gen))
            rews = rews + torch.mean(r)
        clock.mark()
        metrics = {}
        for _ in range(cfg.grad_steps_per_iter):
            state, metrics = self._update(state, self.update_draws(state, gen))
        clock.mark()
        self._clock = clock
        metrics["mean_reward"] = rews / cfg.env_steps_per_iter
        return state._replace(iteration=state.iteration + 1), metrics

    def phase_ms(self) -> dict:
        """Collect and update time of the last :meth:`train_step`, in ms
        (between CUDA events on the device's stream, or on the host clock
        on the CPU); waits for that step to finish."""
        collect, update = self._clock.intervals_ms()
        return {"collect_ms": collect, "update_ms": update}

    # ------------------------------------------------------------------
    def state_tree(self, state: SACState) -> dict:
        """Everything a resumed run needs, as a tree for
        ``utils/checkpoint.save``: the actor and both critic stacks as the
        JAX package's params trees, Adam's step and moments per parameter,
        ``log_alpha``, the replay ring with its pointers, the env state, obs
        and key, and both counts."""
        from rsoccer_tpu_torch import convert

        def adam(opt):
            out = []
            for group in opt.param_groups:
                for p in group["params"]:
                    st = opt.state.get(p) or {
                        "step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": torch.zeros_like(p),
                    }
                    out.append([st["step"], st["exp_avg"], st["exp_avg_sq"]])
            return out

        buf = state.buffer
        return {
            "actor": convert.sac_actor_to_numpy(state.actor),
            "qs": convert.sac_critics_to_numpy(state.qs),
            "qs_target": convert.sac_critics_to_numpy(state.qs_target),
            "log_alpha": state.log_alpha.detach(),
            "adam": {"actor": adam(state.opt_actor), "qs": adam(state.opt_qs),
                     "alpha": adam(state.opt_alpha)},
            "buffer": {"obs": buf.obs, "action": buf.action, "rdb": buf.rdb,
                       "next_obs": buf.next_obs, "ptr": torch.tensor(buf.ptr),
                       "filled": torch.tensor(buf.filled),
                       "width": torch.tensor(-1 if buf.width is None else buf.width)},
            "env_state": state.env_state,
            "obs": state.obs,
            "env_key": state.env_key,
            "total_steps": torch.tensor(state.total_steps),
            "iteration": torch.tensor(state.iteration),
        }

    def state_from_tree(self, tree: dict) -> SACState:
        """Inverse of :meth:`state_tree`, on a tree of tensors and arrays
        (``utils/checkpoint.restore(path, like=trainer.state_tree(s))``)."""
        from rsoccer_tpu_torch import convert
        from rsoccer_tpu_torch.utils.checkpoint import flatten

        cfg, dev = self.cfg, self.device

        def leaves(t):
            return [torch.as_tensor(x).cpu().numpy() for x in flatten(t)]

        actor = convert.sac_actor_from_leaves(leaves(tree["actor"]), device=dev,
                                              compute_dtype=cfg.compute_dtype)
        qs, qs_target = (convert.sac_critics_from_leaves(leaves(tree[k]), self.benv.obs_size,
                                                         device=dev, compute_dtype=cfg.compute_dtype)
                         for k in ("qs", "qs_target"))
        log_alpha = torch.as_tensor(tree["log_alpha"]).to(dev).clone().requires_grad_(True)

        def adam(params, saved):
            opt = self.make_optimizer(params)
            for p, (step, m, v) in zip(params, saved):
                opt.state[p] = {"step": torch.as_tensor(step).clone(),
                                "exp_avg": torch.as_tensor(m).to(dev).clone(),
                                "exp_avg_sq": torch.as_tensor(v).to(dev).clone()}
            return opt

        b = tree["buffer"]
        buf = Buffer(cfg.buffer_size, self.benv.obs_size, self.benv.action_size, dev)
        for name in ("obs", "action", "rdb", "next_obs"):
            getattr(buf, name).copy_(torch.as_tensor(b[name]))
        buf.ptr, buf.filled = int(b["ptr"]), int(b["filled"])
        buf.width = None if int(b["width"]) < 0 else int(b["width"])
        return SACState(
            actor=actor, qs=qs, qs_target=qs_target, log_alpha=log_alpha,
            opt_actor=adam(list(actor.parameters()), tree["adam"]["actor"]),
            opt_qs=adam(list(qs.parameters()), tree["adam"]["qs"]),
            opt_alpha=adam([log_alpha], tree["adam"]["alpha"]),
            buffer=buf, env_state=tree["env_state"], obs=tree["obs"], env_key=tree["env_key"],
            total_steps=int(tree["total_steps"]), iteration=int(tree["iteration"]),
        )
