"""Frozen-past self-play on VSSSelfPlay-v0 (3v3, both teams policy-driven).

Port of ``examples/selfplay_vss.py``.  The learner drives the blue team;
the yellow team is driven by a frozen snapshot of the learner, playing
through the mirrored view (``envs/vss_selfplay.py``), refreshed every
``--swap-every`` updates.  At every swap the current policy is evaluated
against the frozen opponent (the blue-vs-frozen-past goal rate).

    python -m rsoccer_tpu_torch.examples.selfplay_vss --envs 2048 --updates 400 \
        --swap-every 20 --minibatch-mode time --ou-frac 0.5 --anchor-gate

``--ou-frac``: the share of env lanes whose yellow team is the reference
OU process instead of the frozen policy.  ``--anchor-gate``: at every
swap, also evaluate on the ``VSSMultiAgent-v0`` OU anchor and promote the
snapshot to opponent only if its anchor goal rate did not regress by more
than ``--anchor-margin``; ``--save`` then writes the best-anchor
``{params, obs_norm}`` in the JAX package's ``.npz`` layout
(``convert.load_ppo_checkpoint`` reads it back).  On the card the env
steps run the VSS physics kernel (``--fused-physics``, the default there).
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import rsoccer_tpu_torch as rt
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch import eval as E
from rsoccer_tpu_torch.models.networks import ActorCritic
from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer, make_policy
from rsoccer_tpu_torch.models.selfplay import SelfPlayBatchedEnv
from rsoccer_tpu_torch.utils import checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--envs", type=int, default=2048)
    p.add_argument("--updates", type=int, default=120)
    p.add_argument("--swap-every", type=int, default=20)
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument("--eval-steps", type=int, default=1200)
    p.add_argument("--eval-envs", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", default="")
    p.add_argument("--minibatch-mode", default="shuffle", choices=["shuffle", "time"])
    p.add_argument("--ou-frac", type=float, default=0.0,
                   help="share of env lanes whose yellow team is the reference OU process")
    p.add_argument("--anchor-gate", action="store_true",
                   help="promote a snapshot only if its VSSMultiAgent-v0 anchor did not regress")
    p.add_argument("--anchor-envs", type=int, default=512)
    p.add_argument("--anchor-steps", type=int, default=1500)
    p.add_argument("--anchor-margin", type=float, default=0.02,
                   help="tolerated anchor regression when promoting an opponent")
    p.add_argument("--hidden", default="256,256", help="comma-separated tower widths")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    p.add_argument("--fused-physics", action=argparse.BooleanOptionalAction, default=None,
                   help="step the physics through the VSS physics kernel (default: on for cuda)")
    return p


def run(args, on_swap=None) -> dict:
    """Train; returns {"history", "trainer", "state", "best"} (``best``:
    the best anchor's ``anchor``, ``net`` and ``obs_norm``).
    ``on_swap(record)`` is called with each swap's record."""
    fused_physics = args.device == "cuda" if args.fused_physics is None else args.fused_physics
    env = rt.make("VSSSelfPlay-v0")
    hidden = tuple(int(h) for h in args.hidden.split(","))
    init_net = ActorCritic(env.obs_size, env.action_size // 2, hidden, device=args.device, seed=args.seed)
    sp_env = SelfPlayBatchedEnv(env, args.envs, init_net, ou_lanes=int(round(args.ou_frac * args.envs)),
                                device=args.device, fused_physics=fused_physics)
    trainer = PPOTrainer(sp_env, PPOConfig(rollout_steps=args.rollout_steps,
                                           minibatch_mode=args.minibatch_mode, hidden=hidden))
    state = trainer.init(args.seed)

    eval_env = SelfPlayBatchedEnv(env, args.eval_envs, init_net, device=args.device,
                                  fused_physics=fused_physics)
    success = E.success_criterion("VSSSelfPlay-v0")

    def run_eval(net, obs_norm, payload, seed):
        """The deterministic learner against the given frozen opponent."""
        def swap(c):
            return c._replace(state=(c.state[0], payload))

        return E.make_eval_fn(eval_env, args.eval_steps, make_policy(net, obs_norm), success,
                              carry_init=swap)(seed)

    anchor_benv = None
    if args.anchor_gate:
        # the absolute anchor: 3 policy blues against the reference's
        # OU-driven yellows (what tools/vss_anchor_eval measures)
        anchor_benv = rt.make_vec("VSSMultiAgent-v0", args.anchor_envs, device=args.device,
                                  fused_physics=fused_physics)
        anchor_success = E.success_criterion("VSSMultiAgent-v0")

    history = []
    opp_payload = eval_env.payload_from(init_net)
    best = {"anchor": -1.0, "net": None, "obs_norm": None}
    promoted_anchor = -1.0
    t0 = time.perf_counter()
    for u in range(1, args.updates + 1):
        state, metrics = trainer.train_step(state)
        if u % args.swap_every:
            continue
        phase = trainer.phase_ms()  # the update just taken (syncs)
        ms = run_eval(state.net, state.obs_norm, opp_payload, 10_000 + u)
        rec = {"update": u, "goalrate_vs_frozen": float(ms.success_rate),
               "episodes_vs_frozen": int(ms.episodes), "mean_reward": float(metrics["mean_reward"]),
               **phase}
        promote = True
        if anchor_benv is not None:
            ams = E.make_eval_fn(anchor_benv, args.anchor_steps, make_policy(state.net, state.obs_norm),
                                 anchor_success)(20_000 + u)
            anchor = float(ams.success_rate)
            rec.update(anchor_goal_rate=anchor, anchor_episodes=int(ams.episodes))
            if anchor > best["anchor"]:
                best = {"anchor": anchor, "net": copy.deepcopy(state.net),
                        "obs_norm": type(state.obs_norm)(*(t.clone() for t in state.obs_norm))}
            # a generation that regressed on the anchor does not become the
            # next opponent (the drift brake)
            promote = anchor >= promoted_anchor - args.anchor_margin
            rec["promoted"] = promote
        rec["seconds"] = time.perf_counter() - t0
        print(
            f"update {u:4d}  reward/step={rec['mean_reward']:+.4f}  episodes={rec['episodes_vs_frozen']}  "
            f"goalrate_vs_frozen={rec['goalrate_vs_frozen']:.3f}"
            + (f"  anchor={rec['anchor_goal_rate']:.3f}{'' if promote else '  (not promoted)'}"
               if anchor_benv is not None else "")
            + f"  ({rec['seconds']:.0f}s)",
            flush=True,
        )
        history.append(rec)
        if on_swap is not None:
            on_swap(rec)
        if promote:
            # the current learner becomes the next frozen opponent: a copy
            # swapped into the env state
            opp_payload = eval_env.payload_from(state.net, state.obs_norm)
            state = SelfPlayBatchedEnv.swap_opponent(state, opp_payload)
            if anchor_benv is not None:
                promoted_anchor = max(promoted_anchor, rec["anchor_goal_rate"])
    return {"history": history, "trainer": trainer, "state": state, "best": best}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = run(args)
    print(json.dumps(out["history"]))
    if args.save:
        # the obs normaliser goes with the params: params alone would feed
        # the network unnormalised observations
        best, state = out["best"], out["state"]
        if args.anchor_gate and best["net"] is not None:
            checkpoint.save(args.save, convert.ppo_to_numpy(best["net"], best["obs_norm"]))
            print(f"saved BEST-anchor {{params, obs_norm}} (anchor={best['anchor']:.3f}) to {args.save}")
        else:
            checkpoint.save(args.save, convert.ppo_to_numpy(state.net, state.obs_norm))
            print(f"saved {{params, obs_norm}} to {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
