"""PPO trainer over the port's batched env.

Port of ``rsoccer_tpu/models/ppo.py``.  One :meth:`PPOTrainer.train_step`
is one PPO iteration: ``rollout_steps`` batched env steps through
``BatchedEnv.step_final`` (on the fused path, K1's ``emit_final`` kernel
variant), GAE with the truncation bootstrap, and ``num_epochs`` x
``num_minibatches`` clipped-surrogate Adam steps.  The JAX package compiles
the iteration into one program; here it is a Python loop of launches on
the env's device with no host sync inside it (nothing reads a value back
until the caller does).

The network and optimiser are torch objects updated in place: a
:class:`TrainState` carries the :class:`ActorCritic` (the JAX package's
``params``) and its ``torch.optim.Adam`` (``opt_state``) beside the env
state, and ``train_step`` steps both.  Randomness comes from explicit
streams: the policy's normals from ``TrainState.pol_gen``, the per-epoch
permutations from ``TrainState.perm_gen`` (``torch.Generator``s on the
env's device), the env noise from the batch's Philox key.  ``_rollout``
and ``_update`` also take those draws as arguments, so a test can feed the
JAX package's.

With ``mesh`` (``parallel/mesh.EnvMesh``) the trainer is one rank of a
data-parallel PPO: the counterpart of the JAX package's jit-partitioned
train step (``tools/distributed_smoke.py --impl ppo``).  ``benv`` is the
GLOBAL batched env; the rank steps its shard (``parallel/mesh.local_benv``)
and draws the policy's normals for the global batch, keeping its rows, so
the shards collect what the unsharded trainer collects.  Minibatches come
from the global permutation, the advantage and obs moments are merged
over the ranks, the losses are the rank's parts of the global means, and
the gradients are summed over the ranks before the clip
(``parallel/ppo.py``): every rank starts from the first rank's network
and steps the same bits, and the update
equals the unsharded one up to the order of the sums (bit for bit at one
rank).

Where the JAX package's library calls differ from torch's, the port
follows the JAX package: population statistics (``correction=0``),
optax's ``clip_by_global_norm`` (scale by ``max_norm / norm`` only when
``norm >= max_norm``), and a critic warmup that multiplies the actor's
gradients by 0 (a ``None`` gradient would stop torch's Adam from counting
the step, and its bias correction would then differ from optax's).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.models.networks import (
    ActorCritic,
    check_device,
    gaussian_entropy,
    gaussian_logp,
    sample_action,
)
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.parallel import ppo as dp
from rsoccer_tpu_torch.parallel.mesh import (
    EnvMesh, all_reduce_grads, all_reduce_sum, batch_slice, broadcast_params, gather_rows, local_benv,
)


class PPOConfig(NamedTuple):
    rollout_steps: int = 128
    num_epochs: int = 4
    num_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    anneal_updates: int = 0  # >0: linear lr decay to 0 over this many updates
    max_grad_norm: float = 0.5
    normalize_obs: bool = True  # running mean/std normalisation
    # keep normalising with the restored stats but stop updating them
    # (fine-tuning a warm-started policy)
    freeze_obs_norm: bool = False
    # freeze the actor (and log_std) for the first N updates so a fresh
    # value head fits the returns before its noise reaches the policy
    critic_warmup_updates: int = 0
    # "shuffle": a fresh permutation of all T*B samples per epoch; "time":
    # permute the time axis only, minibatch = T/num_minibatches random
    # steps x all envs
    minibatch_mode: str = "shuffle"
    hidden: tuple = (256, 256)  # actor/critic tower widths


class ObsNorm(NamedTuple):
    """Running mean/var (batched moment updates)."""

    mean: torch.Tensor  # (O,)
    var: torch.Tensor  # (O,)
    count: torch.Tensor  # scalar

    @staticmethod
    def init(obs_size: int, device="cuda"):
        device = check_device(device)
        return ObsNorm(
            mean=torch.zeros((obs_size,), device=device),
            var=torch.ones((obs_size,), device=device),
            count=torch.tensor(1e-4, device=device),
        )

    def update(self, batch):
        """batch (N, O) -> updated stats."""
        return self.update_moments(batch.mean(0), batch.var(0, correction=0), batch.shape[0])

    def update_moments(self, b_mean, b_var, b_count):
        delta = b_mean - self.mean
        tot = self.count + b_count
        mean = self.mean + delta * (b_count / tot)
        m_a = self.var * self.count
        m_b = b_var * b_count
        m2 = m_a + m_b + delta**2 * (self.count * b_count / tot)
        return ObsNorm(mean=mean, var=m2 / tot, count=tot)

    def normalize(self, obs):
        """obs (..., O) -> normalised, clipped to +-10."""
        return torch.clamp((obs - self.mean) / torch.sqrt(self.var + 1e-8), -10.0, 10.0)


class TrainState(NamedTuple):
    net: ActorCritic  # the policy's parameters (the JAX package's ``params``)
    opt: torch.optim.Adam  # its optimiser (``opt_state``)
    env_state: object  # batched env state (batch-last leaves, packed (S, B), or self-play's (inner, payload))
    obs: torch.Tensor  # (O, B)
    env_key: torch.Tensor  # the batch's Philox key (advanced by every step)
    obs_norm: ObsNorm
    update_step: int
    pol_gen: torch.Generator  # the policy's normals
    perm_gen: torch.Generator  # the update phase's permutations


class Transition(NamedTuple):
    """A rollout's stacks, each ``(T, B, ...)``."""

    obs: torch.Tensor  # (T, B, O) normalised
    action: torch.Tensor  # (T, B, A) unclipped sample
    logp: torch.Tensor  # (T, B)
    value: torch.Tensor  # (T, B)
    reward: torch.Tensor  # (T, B)
    term: torch.Tensor  # (T, B) terminated (true episode end), 0/1
    trunc: torch.Tensor  # (T, B) truncated (time limit, not terminal), 0/1
    # V(final pre-reset obs): the GAE bootstrap on truncated lanes
    # (gymnasium truncation semantics: a truncated episode is not terminal)
    boot_value: torch.Tensor  # (T, B)


class PhaseClock:
    """Marks between a train step's phases: CUDA events on the device's
    stream (no sync when marked), or the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def make_policy(net: ActorCritic, obs_norm: ObsNorm | None = None, deterministic: bool = True):
    """Lane-layout policy ``policy(gen, obs (O, B)) -> actions (A, B)`` in
    [-1, 1] for ``batch/rollout`` and ``eval``: the mean action, or a
    Gaussian sample drawn from ``gen``."""

    def policy(gen, obs):
        with torch.no_grad():
            o = obs.T if obs_norm is None else obs_norm.normalize(obs.T)
            if deterministic:
                act = net.policy_mean(o)
            else:
                mean, log_std, _ = net(o)
                act, _ = sample_action(gen, mean, log_std)
            return torch.clamp(act.T, -1.0, 1.0).contiguous()

    return policy


class PPOTrainer:
    def __init__(self, benv: BatchedEnv, config: PPOConfig = PPOConfig(), mesh: EnvMesh | None = None):
        """``mesh``: this trainer is one rank of a data-parallel PPO over
        the global ``benv`` (module docstring); None: the whole batch."""
        self.mesh = mesh
        self.n_global = benv.n_envs
        if mesh is not None:
            self.cols = batch_slice(mesh, benv.n_envs)
            benv = local_benv(benv, mesh)
        self.benv = benv
        self.cfg = config
        self.device = check_device(benv.device)
        if config.minibatch_mode not in ("shuffle", "time"):
            raise ValueError(f"unknown minibatch_mode {config.minibatch_mode!r}")
        if config.minibatch_mode == "time" and config.rollout_steps % config.num_minibatches:
            raise ValueError(
                "minibatch_mode='time' needs rollout_steps divisible by "
                f"num_minibatches ({config.rollout_steps} % {config.num_minibatches})"
            )
        self._clock = None

    # ------------------------------------------------------------------
    def init(self, seed: int) -> TrainState:
        cfg, benv, dev = self.cfg, self.benv, self.device
        net = ActorCritic(benv.obs_size, benv.action_size, cfg.hidden, device=dev, seed=seed)
        if self.mesh is not None:  # every rank starts from the first rank's network
            broadcast_params(net.parameters(), self.mesh)
        key = make_key(seed, stream=1, device=dev)
        env_state, obs = benv.reset(key)
        return TrainState(
            net=net,
            opt=self.make_optimizer(net),
            env_state=env_state,
            obs=obs,
            env_key=key,
            obs_norm=ObsNorm.init(benv.obs_size, dev),
            update_step=0,
            pol_gen=torch.Generator(device=dev).manual_seed(2 * seed),
            perm_gen=torch.Generator(device=dev).manual_seed(2 * seed + 1),
        )

    def make_optimizer(self, net: ActorCritic) -> torch.optim.Adam:
        """Adam with optax's defaults (eps 1e-8, no eps_root); the learning
        rate is set before every step (:meth:`_lr`)."""
        return torch.optim.Adam(net.parameters(), lr=self.cfg.lr, eps=1e-8)

    def _lr(self, opt_step: int) -> float:
        """optax's linear schedule, ticking per optimiser step: the full
        rate at step 0, 0 after anneal_updates x num_epochs x
        num_minibatches steps."""
        cfg = self.cfg
        if cfg.anneal_updates <= 0:
            return cfg.lr
        n = cfg.anneal_updates * cfg.num_epochs * cfg.num_minibatches
        return cfg.lr * (1.0 - min(opt_step, n) / n)

    # ------------------------------------------------------------------
    def _rollout(self, net, env_state, obs, env_key, obs_norm, gen, draws=None):
        """Collect ``rollout_steps`` transitions; obs is lane-layout (O, B).

        ``draws``: ``(action_noise (T, B, A), [(t_noise, r_noise)] * T)``,
        the policy's normals and each step's env noise, in place of ``gen``
        and ``env_key`` (which then stay untouched).  Returns (env_state,
        obs, env_key, (raw_mean, raw_var, n), traj)."""
        cfg, benv = self.cfg, self.benv
        n_t, b = cfg.rollout_steps, benv.n_envs
        dev = obs.device

        def stack(*tail):
            return torch.empty((n_t, b, *tail), device=dev)

        traj = Transition(
            obs=stack(benv.obs_size), action=stack(benv.action_size), logp=stack(),
            value=stack(), reward=stack(), term=stack(), trunc=stack(), boot_value=stack(),
        )

        def norm(o):
            return obs_norm.normalize(o.T) if cfg.normalize_obs else o.T

        o_sum = torch.zeros((benv.obs_size,), device=dev)
        o_sq = torch.zeros((benv.obs_size,), device=dev)
        with torch.no_grad():
            for t in range(n_t):
                # raw-obs moment sums feed the running normaliser
                o_sum += obs.sum(-1)
                o_sq += (obs * obs).sum(-1)
                net_obs = norm(obs)
                mean, log_std, value = net(net_obs)
                if draws is not None:
                    noise = draws[0][t]
                elif self.mesh is not None:  # the global batch's normals, this rank's rows
                    noise = torch.randn((self.n_global, benv.action_size), generator=gen, device=dev,
                                        dtype=mean.dtype)[self.cols]
                else:
                    noise = None
                action, logp = sample_action(gen, mean, log_std, noise)
                # the envs' action spaces are Box(-1, 1): clip at the env
                # boundary, keeping the unclipped sample for the log-prob
                act = torch.clamp(action.T, -1.0, 1.0).contiguous()
                if draws is None:
                    env_state, obs, fobs, reward, term, trunc, _ = benv.step_final(
                        env_state, act, env_key
                    )
                else:
                    env_state, obs, fobs, reward, term, trunc, _ = benv.step_final_with_noise(
                        env_state, act, *draws[1][t]
                    )
                for buf, x in zip(traj, (net_obs, action, logp, value, reward, term, trunc,
                                         net.value(norm(fobs)))):
                    buf[t] = x
        n = n_t * b
        raw_mean = o_sum / n
        raw_var = torch.clamp_min(o_sq / n - raw_mean**2, 0.0)
        if self.mesh is not None:  # the global moments: every rank's, merged in rank order
            rows = gather_rows(torch.stack([raw_mean, raw_var]), self.mesh)
            n, raw_mean, raw_var = dp.merge_mean_var([n] * self.mesh.world, rows[:, 0], rows[:, 1])
        return env_state, obs, env_key, (raw_mean, raw_var, n), traj

    def _gae(self, traj: Transition, last_value):
        """GAE, a reverse loop over T.  Truncated lanes bootstrap from the
        value of the final pre-reset obs (value_{t+1} is the next episode's
        spawn there); terminated lanes do not bootstrap (terminal wins when
        both are set)."""
        cfg = self.cfg
        next_value = torch.cat([traj.value[1:], last_value[None]], dim=0)
        nv = torch.where(traj.trunc > 0.5, traj.boot_value, next_value)
        delta = traj.reward + cfg.gamma * nv * (1.0 - traj.term) - traj.value
        done = torch.maximum(traj.term, traj.trunc)
        c = cfg.gamma * cfg.gae_lambda * (1.0 - done)
        advantages = torch.empty_like(delta)
        acc = torch.zeros_like(last_value)
        for t in range(delta.shape[0] - 1, -1, -1):
            acc = delta[t] + c[t] * acc
            advantages[t] = acc
        return advantages, advantages + traj.value

    def _loss(self, net, batch: Transition, advantages, returns, shard: dp.MinibatchShard | None = None):
        """The clipped-surrogate loss; with ``shard``, the rank's part of
        the global minibatch's loss (its members' terms of the global
        means, the entropy term over the ranks)."""
        cfg = self.cfg
        mean, log_std, value = net(batch.obs)
        logp = gaussian_logp(batch.action, mean, log_std)
        ratio = torch.exp(logp - batch.logp)
        if shard is None:
            adv = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        else:
            adv = (advantages - shard.adv_mean) / (shard.adv_std + 1e-8)
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
        batch_mean = torch.mean if shard is None else shard.mean
        policy_loss = -batch_mean(torch.minimum(unclipped, clipped))
        value_loss = 0.5 * batch_mean((value - returns) ** 2)
        entropy = gaussian_entropy(log_std)
        ent_term = cfg.ent_coef * entropy
        if shard is not None:
            ent_term = ent_term / shard.world
        total = policy_loss + cfg.vf_coef * value_loss - ent_term
        metrics = {
            "loss": total,
            "policy_loss": policy_loss,
            "value_loss": value_loss,
            "entropy": entropy,
        }
        return total, metrics

    def _apply_minibatch(self, net, opt, batch, adv_b, ret_b, actor_frozen: bool, opt_step: int,
                         counts=None):
        """One Adam step on one minibatch; returns the loss metrics.  On a
        mesh ``counts`` is every rank's member count of the minibatch."""
        opt.zero_grad(set_to_none=False)
        shard = None
        if self.mesh is not None:
            with torch.no_grad():
                adv_mean, adv_std = dp.global_mean_std(adv_b, counts, self.mesh)
            shard = dp.MinibatchShard(counts[self.mesh.rank], sum(counts), adv_mean, adv_std,
                                      self.mesh.world)
        loss, metrics = self._loss(net, batch, adv_b, ret_b, shard)
        loss.backward()
        params = list(net.parameters())
        if self.mesh is not None:
            all_reduce_grads(params, self.mesh)
        if actor_frozen:
            for p in net.actor_parameters():
                p.grad.mul_(0.0)
        # optax.clip_by_global_norm
        grads = [p.grad for p in params]
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        max_norm = self.cfg.max_grad_norm
        for g in grads:
            g.copy_(torch.where(g_norm < max_norm, g, g / g_norm * max_norm))
        for group in opt.param_groups:
            group["lr"] = self._lr(opt_step)
        opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    def permutations(self, gen) -> list:
        """The update phase's draws: one permutation per epoch, of the
        T x B samples ("shuffle") or of the T steps ("time")."""
        cfg = self.cfg
        n = cfg.rollout_steps * (1 if cfg.minibatch_mode == "time" else self.n_global)
        return [torch.randperm(n, generator=gen, device=gen.device) for _ in range(cfg.num_epochs)]

    def _update(self, net, opt, traj: Transition, last_value, update_step: int, perms):
        """The update phase: GAE, then num_epochs passes of num_minibatches
        Adam steps, epoch e over ``perms[e]``.  Returns the last
        minibatch's metrics."""
        cfg = self.cfg
        advantages, returns = self._gae(traj, last_value)
        frozen = update_step < cfg.critic_warmup_updates
        n_mb = cfg.num_minibatches
        mesh = self.mesh
        if cfg.minibatch_mode == "time":
            # permute the time axis only: minibatch = mt random steps x
            # all envs, read as contiguous (B, ...) rows (on a mesh: the
            # rank's envs; every rank holds mt x B_local members)
            mt = cfg.rollout_steps // n_mb
            counts = None if mesh is None else [mt * self.benv.n_envs] * mesh.world

            def minibatch(e, k):
                idx = perms[e][k * mt:(k + 1) * mt]

                def take(x):
                    x = x[idx]
                    return x.reshape((-1,) + x.shape[2:])

                return Transition(*map(take, traj)), take(advantages), take(returns), counts
        else:
            # flatten (T, B) -> (N,) and gather fresh random rows per epoch
            flat = Transition(*(x.reshape((-1,) + x.shape[2:]) for x in traj))
            adv_f, ret_f = advantages.reshape(-1), returns.reshape(-1)
            if mesh is None:
                mb = adv_f.shape[0] // n_mb

                def minibatch(e, k):
                    idx = perms[e][k * mb:(k + 1) * mb]
                    return Transition(*(x[idx] for x in flat)), adv_f[idx], ret_f[idx], None
            else:  # the global minibatch's members on this rank
                local, all_counts = dp.minibatch_members(
                    perms, n_mb, cfg.rollout_steps * self.n_global, self.n_global, mesh)

                def minibatch(e, k):
                    idx = local[e, k, :all_counts[e][k][mesh.rank]]
                    return (Transition(*(x[idx] for x in flat)), adv_f[idx], ret_f[idx],
                            all_counts[e][k])

        metrics = None
        for e in range(len(perms)):
            for k in range(n_mb):
                opt_step = (update_step * cfg.num_epochs + e) * n_mb + k
                batch, adv_b, ret_b, counts_k = minibatch(e, k)
                metrics = self._apply_minibatch(net, opt, batch, adv_b, ret_b, frozen, opt_step, counts_k)
        return metrics

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState):
        """One full PPO iteration.  Steps ``state.net`` and ``state.opt`` in
        place; returns (the new TrainState, metrics as device scalars)."""
        cfg = self.cfg
        clock = PhaseClock(self.device)
        clock.mark()
        env_state, obs, env_key, raw_moments, traj = self._rollout(
            state.net, state.env_state, state.obs, state.env_key, state.obs_norm, state.pol_gen
        )
        clock.mark()
        with torch.no_grad():
            last_obs = state.obs_norm.normalize(obs.T) if cfg.normalize_obs else obs.T
            last_value = state.net.value(last_obs)
        metrics = self._update(
            state.net, state.opt, traj, last_value, state.update_step,
            self.permutations(state.perm_gen),
        )
        clock.mark()
        self._clock = clock
        obs_norm = (
            state.obs_norm.update_moments(*raw_moments)
            if cfg.normalize_obs and not cfg.freeze_obs_norm
            else state.obs_norm
        )
        new_state = state._replace(
            env_state=env_state, obs=obs, env_key=env_key, obs_norm=obs_norm,
            update_step=state.update_step + 1,
        )
        out_metrics = {
            **metrics,
            "mean_reward": traj.reward.mean(),
            "mean_episode_ends": torch.maximum(traj.term, traj.trunc).sum(),
        }
        if self.mesh is not None:  # global: the loss parts and episode ends summed, the reward's mean
            keys = ("loss", "policy_loss", "value_loss", "mean_reward", "mean_episode_ends")
            out_metrics["mean_reward"] = out_metrics["mean_reward"] * (self.benv.n_envs / self.n_global)
            summed = all_reduce_sum(torch.stack([out_metrics[k] for k in keys]), self.mesh)
            out_metrics.update(zip(keys, summed))
        return new_state, out_metrics

    def phase_ms(self) -> dict:
        """Collect and update time of the last :meth:`train_step`, in ms
        (between CUDA events on the device's stream, or on the host clock
        on the CPU); waits for that step to finish."""
        collect, update = self._clock.intervals_ms()
        return {"collect_ms": collect, "update_ms": update}

    # ------------------------------------------------------------------
    def state_tree(self, state: TrainState) -> dict:
        """Everything a resumed run needs, as a tree for
        ``utils/checkpoint.save``: the policy as the JAX package's
        ``{params, obs_norm}`` tree, Adam's step and moments per parameter,
        the env state (with self-play's frozen-opponent payload, a tree of
        tensors), obs and key, the update count and both generators'
        states."""
        from rsoccer_tpu_torch import convert

        adam = []
        for p in state.net.parameters():
            st = state.opt.state.get(p) or {
                "step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p),
            }
            adam.append([st["step"], st["exp_avg"], st["exp_avg_sq"]])
        return {
            **convert.ppo_to_numpy(state.net, state.obs_norm),
            "adam": adam,
            "env_state": state.env_state,
            "obs": state.obs,
            "env_key": state.env_key,
            "update_step": torch.tensor(state.update_step),
            "pol_gen": state.pol_gen.get_state(),
            "perm_gen": state.perm_gen.get_state(),
        }

    def state_from_tree(self, tree: dict) -> TrainState:
        """Inverse of :meth:`state_tree`, on a tree of tensors and arrays
        (``utils/checkpoint.restore(path, like=trainer.state_tree(s))``)."""
        from rsoccer_tpu_torch import convert
        from rsoccer_tpu_torch.utils.checkpoint import flatten

        dev = self.device
        leaves = flatten({"obs_norm": tree["obs_norm"], "params": tree["params"]})
        net, obs_norm = convert.ppo_from_leaves(
            [torch.as_tensor(x).cpu().numpy() for x in leaves], device=dev
        )
        opt = self.make_optimizer(net)
        for p, (step, m, v) in zip(net.parameters(), tree["adam"]):
            opt.state[p] = {"step": torch.as_tensor(step).clone(), "exp_avg": torch.as_tensor(m).to(dev),
                            "exp_avg_sq": torch.as_tensor(v).to(dev)}
        pol_gen = torch.Generator(device=dev)
        pol_gen.set_state(torch.as_tensor(tree["pol_gen"]))
        perm_gen = torch.Generator(device=dev)
        perm_gen.set_state(torch.as_tensor(tree["perm_gen"]))
        return TrainState(
            net=net, opt=opt, env_state=tree["env_state"], obs=tree["obs"],
            env_key=tree["env_key"], obs_norm=obs_norm,
            update_step=int(tree["update_step"]), pol_gen=pol_gen, perm_gen=perm_gen,
        )
