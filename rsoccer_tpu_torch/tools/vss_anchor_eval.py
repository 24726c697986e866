"""Absolute VSS anchor numbers for a policy: goal rate AND goal diff.

Port of ``tools/vss_anchor_eval.py``: a ``{params, obs_norm}`` checkpoint
on the reference's own opponent distribution (OU-driven robots), with a
deterministic policy, ``--envs`` envs for ``--steps`` steps; prints the
episodes, blue and yellow goal rates, the truncation rate and the mean
goal difference per episode.  ``--env-id VSS-v0`` scores a single-agent
policy (one learned blue, two OU teammates), ``VSSMultiAgent-v0`` a
league policy (three learned blues).

    python -m rsoccer_tpu_torch.tools.vss_anchor_eval --env-id VSS-v0 \
        --params artifacts/vss_ppo.ckpt.npz --envs 1024 --steps 4800 --fused
    python -m rsoccer_tpu_torch.tools.vss_anchor_eval --env-id VSSMultiAgent-v0 \
        --params artifacts/selfplay_vss_r3.ckpt.npz

On the card the steps run a kernel: ``--fused`` (VSS-v0 only) the whole
step in one launch, ``--fused-physics`` (the default for
``VSSMultiAgent-v0`` on the card) the physics in one launch.
"""

from __future__ import annotations

import argparse
import json

import torch

import rsoccer_tpu_torch as rt
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.batch import rollout as R
from rsoccer_tpu_torch.models.ppo import make_policy

ENV_IDS = ("VSS-v0", "VSSMultiAgent-v0")


def anchor_eval(benv, policy, n_steps: int, seed: int = 123) -> dict:
    """Run ``policy`` on ``benv`` for ``n_steps`` steps from a fresh reset
    and count, over the episodes that end, blue goals, yellow goals and
    truncations."""
    carry = R.init_carry(benv, seed)
    state, obs = carry.state, carry.obs
    total = torch.zeros(4, device=benv.device)
    for _ in range(n_steps):
        state, obs, _, term, trunc, info = benv.step(state, policy(carry.pol_gen, obs), carry.key)
        done = (term | trunc).float()
        total += torch.stack([done.sum(), (done * info["goals_blue"]).sum(),
                              (done * info["goals_yellow"]).sum(), (done * trunc.float()).sum()])
    eps, gb, gy, tr = total.tolist()
    n = max(eps, 1.0)
    return {
        "episodes": int(eps),
        "blue_goal_rate": gb / n,
        "yellow_goal_rate": gy / n,
        "truncation_rate": tr / n,
        "mean_goal_diff": (gb - gy) / n,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--env-id", default="VSS-v0", choices=ENV_IDS)
    p.add_argument("--params", required=True, help="a {params, obs_norm} .npz checkpoint")
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=4800)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fused", action="store_true",
                   help="VSS-v0 only: step through the env's fused kernel (kernel RNG)")
    p.add_argument("--fused-physics", action=argparse.BooleanOptionalAction, default=None,
                   help="step the physics through the VSS physics kernel "
                        "(default: on for VSSMultiAgent-v0 on cuda)")
    args = p.parse_args(argv)
    if args.fused and args.env_id != "VSS-v0":
        p.error(f"--fused is VSS-v0's whole-step kernel; {args.env_id} runs on the physics "
                "kernel (--fused-physics)")
    fused_physics = args.fused_physics
    if fused_physics is None:
        fused_physics = args.env_id != "VSS-v0" and args.device == "cuda"

    benv = rt.make_vec(args.env_id, args.envs, device=args.device, fused=args.fused,
                       fused_rng="kernel", fused_physics=fused_physics)
    net, obs_norm = convert.load_ppo_checkpoint(args.params, device=benv.device)
    if (net.obs_size, net.action_size) != (benv.obs_size, benv.action_size):
        p.error(f"{args.params} has obs {net.obs_size} and actions {net.action_size}; "
                f"{args.env_id} has {benv.obs_size} and {benv.action_size}")
    out = {"env_id": args.env_id, "params": args.params, "fused": args.fused, "fused_physics": fused_physics,
           **anchor_eval(benv, make_policy(net, obs_norm, deterministic=True), args.steps)}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
