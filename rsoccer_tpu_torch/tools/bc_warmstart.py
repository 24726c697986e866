"""Behavior-cloning warm start from a scripted expert.

Port of ``tools/bc_warmstart.py``: collects (obs, action) pairs by rolling
a scripted expert (``rsoccer_tpu_torch/experts.py``) through the batched
env, fits the actor's mean to the expert actions (plus DAgger rounds: roll
the clone, label every visited state with the expert, refit on the
aggregate), sets the actor's std from the fit's residuals, and writes the
JAX package's checkpoint: ``{params, obs_norm}`` for a PPO ``ActorCritic``
(``--target ppo``, for ``train_ppo_vss.py --init``) or ``{actor_params}``
for a SAC actor (``--target sac``, fit in atanh space so that
``tanh(mean)`` is the expert action; for ``train_sac_vss.py --init``).

    python -m rsoccer_tpu_torch.tools.bc_warmstart --env-id SSLPassEndurance-v0 \
        --dagger-iters 2 --save chiprun_out/pe_bc.ckpt --eval-steps 2400

The collect env runs the training-time curriculum resets (``--curriculum
1``), which the fused kernels refuse, so it steps the unfused env; with
``--curriculum 0`` it steps the fused kernel and the expert reads the
state through ``BatchedEnv.unpack_state``.  The eval runs on the
reference-exact env through its fused kernel.

Unlike the JAX tool, :func:`fit` raises when there are fewer pairs than
``--minibatch`` (the JAX tool's epochs then run zero minibatches, return
the params untouched and print a ``nan`` loss).
"""

from __future__ import annotations

import argparse
import time

import torch

from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.experts import EXPERTS
from rsoccer_tpu_torch.models import ppo, sac
from rsoccer_tpu_torch.models.networks import ActorCritic, check_device
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.registry import make

_ATANH_CLIP = 0.999  # the SAC target: atanh(clip(y, -0.999, 0.999))


def actor_mean(net):
    """``x (N, O) -> mean (N, A)`` of a PPO ``ActorCritic`` or a SAC
    ``SquashedGaussianActor`` (pre-squash)."""
    if isinstance(net, ActorCritic):
        return net.policy_mean
    return lambda x: net(x)[0]


def clone_policy(net, obs_norm):
    """The clone's deterministic action ``policy(gen, obs (O, B)) -> (A,
    B)``: ``clip(mean, -1, 1)`` on normalised obs for PPO, ``tanh(mean)``
    on raw obs for SAC."""
    if isinstance(net, ActorCritic):
        return ppo.make_policy(net, obs_norm, deterministic=True)
    return sac.make_policy(net, deterministic=True)


def collect(benv: BatchedEnv, expert, steps: int, seed: int, behavior: str = "expert",
            net=None, obs_norm=None):
    """Roll ``steps`` batched steps from a fresh reset and label every
    visited state with ``expert``.  ``behavior="expert"`` acts with the
    labels; ``"policy"`` acts with the clone ``net`` (DAgger).  Returns
    ``X (T*B, O)`` and ``Y (T*B, A)``, time-major as the JAX tool's
    ``(T, O, B) -> (T*B, O)``."""
    if behavior not in ("expert", "policy"):
        raise ValueError(f"behavior must be 'expert' or 'policy', got {behavior!r}")
    act_fn = clone_policy(net, obs_norm) if behavior == "policy" else None
    key = make_key(seed, device=benv.device)
    state, obs = benv.reset(key)
    xs, ys = [], []
    with torch.no_grad():
        for _ in range(steps):
            label = expert(benv.unpack_state(state) if benv.fused else state)
            act = label if act_fn is None else act_fn(None, obs)
            xs.append(obs)
            ys.append(label)
            state, obs, *_ = benv.step(state, act, key)
    X = torch.stack(xs).transpose(1, 2).reshape(-1, benv.obs_size)
    Y = torch.stack(ys).transpose(1, 2).reshape(-1, benv.action_size)
    return X, Y


def fit(net, Xn, Y, perms, lr: float, minibatch: int):
    """Regress the actor's mean on ``Y`` (MSE) with a fresh Adam (optax's
    defaults: b1 0.9, b2 0.999, eps 1e-8 outside the square root), one
    epoch per permutation in ``perms`` of ``n // minibatch`` minibatches
    (the remainder dropped).  Updates ``net`` in place; returns the
    per-epoch mean losses ``(len(perms),)``."""
    n = Xn.shape[0]
    if n < minibatch:
        raise ValueError(
            f"{n} pairs is fewer than --minibatch {minibatch}: an epoch would run no "
            "minibatch; collect more pairs (--envs x --steps) or lower --minibatch"
        )
    nb = n // minibatch
    mean_fn = actor_mean(net)
    opt = torch.optim.Adam(net.parameters(), lr=lr, eps=1e-8)
    losses = []
    for perm in perms:
        idx = perm[: nb * minibatch].view(nb, minibatch)
        xb, yb = Xn[idx], Y[idx]  # (nb, minibatch, .): one gather per epoch
        total = torch.zeros((), device=Xn.device)
        for i in range(nb):
            opt.zero_grad()
            loss = torch.mean((mean_fn(xb[i]) - yb[i]) ** 2)
            loss.backward()
            opt.step()
            total += loss.detach()
        losses.append(total / nb)
    return torch.stack(losses)


def set_residual_std(net, Xn, Y):
    """Set the actor's std from the clone's residuals ``sqrt(mean((mean -
    Y)^2))`` per action dim, clipped to [0.1, 1] (the MSE fit leaves the
    std at its init, and std 1 of exploration noise wrecks a precision
    clone the moment RL rolls it; the floor keeps fine-tuning exploring).
    PPO: the ``log_std`` parameter; SAC: the ``log_std`` head's kernel
    zeroed and its bias set, so every state starts there.  Returns the
    residuals ``(A,)``."""
    with torch.no_grad():
        resid = torch.sqrt(torch.mean((actor_mean(net)(Xn) - Y) ** 2, dim=0))
        log_std = torch.log(torch.clamp(resid, 0.1, 1.0))
        if isinstance(net, ActorCritic):
            net.log_std.copy_(log_std)
        else:
            net.log_std.weight.zero_()
            net.log_std.bias.copy_(log_std)
    return resid


def atanh_target(Y):
    """The SAC actor's pre-squash target: ``tanh`` of it is the expert's
    action, clipped off +-1."""
    return torch.atanh(torch.clamp(Y, -_ATANH_CLIP, _ATANH_CLIP))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--env-id", default="SSLDribbling-v0", choices=sorted(EXPERTS))
    p.add_argument("--envs", type=int, default=512)
    p.add_argument("--steps", type=int, default=512)
    p.add_argument("--curriculum", type=int, default=1,
                   help="collect from curriculum resets (state diversity); eval stays "
                   "reference-exact")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--minibatch", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--save", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dagger-iters", type=int, default=0,
                   help="DAgger rounds: roll the cloned policy, label with the expert, "
                   "refit on the aggregate")
    p.add_argument("--eval-steps", type=int, default=0,
                   help="if >0, deterministic eval on the reference env after (256 envs)")
    p.add_argument("--target", default="ppo", choices=["ppo", "sac"],
                   help="ppo: fit the ActorCritic mean ({params, obs_norm} checkpoint); "
                   "sac: fit the SquashedGaussianActor in atanh space on raw obs "
                   "({actor_params} checkpoint)")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    return p


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """The tool on parsed ``args``; prints as it goes and returns what it
    measured: the pairs and collect seconds per round, each fit's
    per-epoch losses and ms per epoch, the residual std per action dim,
    and the eval's metrics (or ``None``)."""
    from rsoccer_tpu_torch import convert
    from rsoccer_tpu_torch.eval import evaluate_policy
    from rsoccer_tpu_torch.utils import checkpoint

    device = check_device(args.device)
    env = make(args.env_id, curriculum=bool(args.curriculum))
    expert = EXPERTS[args.env_id](env)
    benv = BatchedEnv(env, args.envs, device=device, fused=not args.curriculum,
                      fused_rng="kernel")
    O, A = benv.obs_size, benv.action_size
    if args.target == "sac":
        net = sac.SquashedGaussianActor(O, A, device=device,
                                        gen=torch.Generator().manual_seed(args.seed + 1))
    else:
        net = ActorCritic(O, A, device=device, seed=args.seed + 1)
    out = {"pairs": [], "collect_s": [], "mse": [], "fit_ms_per_epoch": []}

    def timed_collect(seed, behavior, obs_norm=None):
        t0 = time.perf_counter()
        X, Y = collect(benv, expert, args.steps, seed, behavior, net, obs_norm)
        _sync(device)
        out["collect_s"].append(time.perf_counter() - t0)
        return X, (atanh_target(Y) if args.target == "sac" else Y)

    def timed_fit(X, Y, perm_seed):
        gen = torch.Generator(device=device).manual_seed(perm_seed)
        perms = [torch.randperm(X.shape[0], generator=gen, device=device)
                 for _ in range(args.epochs)]
        t0 = time.perf_counter()
        ls = fit(net, obs_norm.normalize(X), Y, perms, args.lr, args.minibatch)
        ls = ls.tolist()  # syncs
        out["fit_ms_per_epoch"].append((time.perf_counter() - t0) * 1e3 / args.epochs)
        out["mse"].append(ls)
        out["pairs"].append(X.shape[0])
        return ls

    X, Y = timed_collect(args.seed, "expert")
    print(f"collected {X.shape[0]} expert pairs in {out['collect_s'][-1]:.1f}s", flush=True)
    # SAC nets see raw obs (the normaliser stays the identity); PPO's comes
    # from the expert distribution and stays fixed across DAgger rounds
    obs_norm = ppo.ObsNorm.init(O, device)
    if args.target == "ppo":
        obs_norm = obs_norm.update(X)
    ls = timed_fit(X, Y, args.seed + 2)
    print("bc mse per epoch:", [round(v, 5) for v in ls[:: max(1, args.epochs // 8)]], flush=True)

    for it in range(args.dagger_iters):
        Xi, Yi = timed_collect(args.seed + 100 + it, "policy", obs_norm)
        X, Y = torch.cat([X, Xi]), torch.cat([Y, Yi])
        ls = timed_fit(X, Y, args.seed + 200 + it)
        print(f"dagger {it}: {X.shape[0]} pairs, final mse {ls[-1]:.5f}", flush=True)

    resid = set_residual_std(net, obs_norm.normalize(X), Y)
    out["resid_std"] = resid.tolist()
    print("bc residual std per action dim:", [round(v, 4) for v in out["resid_std"]], flush=True)

    if args.target == "sac":
        checkpoint.save(args.save, {"actor_params": convert.sac_actor_to_numpy(net)})
        print(f"saved SAC actor_params to {args.save}", flush=True)
    else:
        checkpoint.save(args.save, convert.ppo_to_numpy(net, obs_norm))
        print(f"saved params+obs_norm to {args.save}", flush=True)

    out["eval"] = None
    if args.eval_steps:
        out["eval"] = evaluate_policy(args.env_id, clone_policy(net, obs_norm), n_envs=256,
                                      n_steps=args.eval_steps, seed=9, device=device, fused=True)
        e = out["eval"]
        print(f"BC policy eval: episodes={e['episodes']} success_rate={e['success_rate']:.3f} "
              f"mean_return={e['mean_episode_return']:.3f}", flush=True)
    return out


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
