"""Absolute VSS-v0 anchor numbers for a policy: goal rate AND goal diff.

Port of ``tools/vss_anchor_eval.py``: a ``{params, obs_norm}`` checkpoint
on the reference's own opponent distribution (OU-driven robots), with a
deterministic policy, ``--envs`` envs for ``--steps`` steps; prints the
episodes, blue and yellow goal rates, the truncation rate and the mean
goal difference per episode.

    python -m rsoccer_tpu_torch.tools.vss_anchor_eval \
        --params artifacts/vss_ppo.ckpt.npz --envs 1024 --steps 4800 --fused
"""

from __future__ import annotations

import argparse
import json

import torch

import rsoccer_tpu_torch as rt
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.batch import rollout as R
from rsoccer_tpu_torch.models.ppo import make_policy


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
    p.add_argument("--params", required=True, help="a {params, obs_norm} .npz checkpoint")
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=4800)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fused", action="store_true",
                   help="step through the env's fused kernel (kernel RNG)")
    args = p.parse_args(argv)

    benv = rt.make_vec("VSS-v0", args.envs, device=args.device, fused=args.fused,
                       fused_rng="kernel")
    net, obs_norm = convert.load_ppo_checkpoint(args.params, device=benv.device)
    out = {"env_id": "VSS-v0", "params": args.params,
           **anchor_eval(benv, make_policy(net, obs_norm, deterministic=True), args.steps)}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
