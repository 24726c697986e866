"""Evaluate a trained policy: success rate, episode return and length.

    python -m rsoccer_tpu_torch.examples.eval_policy --env-id SSLStaticDefenders-v0 \
        --algo sac --params artifacts/sac_sd_best2.ckpt.npz --envs 1024 --steps 2000 --fused
    python -m rsoccer_tpu_torch.examples.eval_policy --params artifacts/vss_ppo.ckpt.npz
    python -m rsoccer_tpu_torch.examples.eval_policy --device cpu --envs 16 --steps 50 \
        --params artifacts/vss_ppo.ckpt.npz --gif /tmp/episode.gif

``--algo ppo`` reads a ``{params, obs_norm}`` checkpoint (``train_ppo_vss``),
``--algo sac`` an ``actor_params`` one (``train_sac_vss``); both are the
JAX package's ``.npz`` files, read without jax.  The policy acts
deterministically (the mean action, ``tanh`` of it for SAC) on the default
env (``eval.evaluate_policy``).  ``--gif PATH`` then records one episode of
the same policy on a single env and writes it as an animated GIF
(``utils/video.py``: the host renderer needs pygame, and it raises
``ImportError`` where pygame is missing).
"""

from __future__ import annotations

import argparse

from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.eval import evaluate_policy
from rsoccer_tpu_torch.models import ppo, sac
from rsoccer_tpu_torch.models.networks import ActorCritic, check_device
from rsoccer_tpu_torch.registry import make


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--params", default="", help="the checkpoint; without it a fresh init is scored")
    p.add_argument("--algo", default="ppo", choices=["ppo", "sac"],
                   help="checkpoint format: ppo = {params, obs_norm}, sac = the actor's params")
    p.add_argument("--hidden", default="256,256", help="tower widths of the fresh init (no --params)")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    p.add_argument("--fused", action="store_true", help="step through the env's fused kernel")
    p.add_argument("--gif", default="", help="also write one episode of the policy to this GIF")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = check_device(args.device)
    env = make(args.env_id)
    hidden = tuple(int(h) for h in args.hidden.split(","))
    if not args.params:
        print("no --params given; evaluating a freshly initialised policy", flush=True)
    if args.algo == "sac":
        actor = (convert.load_sac_checkpoint(args.params, device=device) if args.params else
                 sac.SquashedGaussianActor(env.obs_size, env.action_size, hidden, device=device))
        policy = sac.make_policy(actor, deterministic=True)
    else:
        if args.params:
            net, obs_norm = convert.load_ppo_checkpoint(args.params, device=device)
        else:
            net = ActorCritic(env.obs_size, env.action_size, hidden, device=device)
            obs_norm = ppo.ObsNorm.init(env.obs_size, device)
        policy = ppo.make_policy(net, obs_norm, deterministic=True)
    out = evaluate_policy(args.env_id, policy, n_envs=args.envs, n_steps=args.steps, seed=1,
                          device=device, fused=args.fused)
    print(f"{args.envs} envs x {args.steps} steps: episodes={out['episodes']} "
          f"success_rate={out['success_rate']:.3f} mean_return={out['mean_episode_return']:.3f} "
          f"mean_length={out['mean_episode_length']:.1f}", flush=True)
    if args.gif:
        from rsoccer_tpu_torch.utils.video import record_episode, save_gif

        frames = record_episode(env, policy=policy, seed=2, max_steps=600, device=device)
        save_gif(frames, args.gif)
        print(f"wrote {args.gif} ({len(frames)} frames)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
