"""Slice SSLStaticDefenders eval success by SPAWN class, on the device.

The counterpart of the JAX package's ``tools/sd_spawn_slice.py``:

    python -m rsoccer_tpu_torch.tools.sd_spawn_slice --params artifacts/sd_ppo3.ckpt \\
        --envs 1024 --steps 2000 [--fused] [--env-kwargs '{"curriculum": true}']

The ~87% PPO plateau concentrates its losses in some spawn classes
(docs/training.md): contested spawns (a defender within 0.3 m of the
ball) and right-end-line balls.  A deterministic policy runs ``--steps``
batched steps; every finished episode is binned by (a) its spawn's
nearest defender-to-ball distance and (b) its spawn ball x, with the
goal rate per bin and the termination modes per distance bin, printed as
the JAX tool's JSON.  Every count stays on the device until the end.

``--fused`` steps the fused StaticDefenders kernel (K4, kernel RNG) and
reads the spawn features through ``benv.unpack_state``; without it the
unfused env steps.  A curriculum (``--env-kwargs '{"curriculum":
true}'``) runs unfused only: the fused kernels implement the reference's
reset and refuse it.  ``--params``: a ``{params, obs_norm}`` checkpoint
(``.npz``, the suffix optional), loaded without jax.
"""

from __future__ import annotations

import argparse
import json

import torch

D_EDGES = (0.3, 0.6, 1.0, 2.0)  # nearest-defender-to-ball bins (m)
X_EDGES = (1.0, 2.0, 3.0, 4.0)  # spawn ball x bins (m); half_len = 4.5
LABELS_D = ["<0.3", "0.3-0.6", "0.6-1.0", "1.0-2.0", ">=2.0"]
LABELS_X = ["0.2-1", "1-2", "2-3", "3-4", "4-4.4"]
# termination-mode indicators: the info keys of the StaticDefenders step
# (envs/ssl_static_defenders._SHAPING_KEYS)
MODES = ("goal", "rbt_in_gk_area", "done_ball_out", "done_ball_out_right", "done_rbt_out")
SEED = 42


def _spawn_features(state):
    """(nearest defender-to-ball distance, ball x) from a structured state."""
    bx, by = state.world.ball.x, state.world.ball.y
    yx, yy = state.world.robots.x[1:], state.world.robots.y[1:]
    d = torch.sqrt((yx - bx[None]) ** 2 + (yy - by[None]) ** 2).amin(dim=0)
    return d, bx


def spawn_slice(benv, policy, n_steps: int, seed: int = SEED) -> dict:
    """Run ``policy`` on ``benv`` for ``n_steps`` steps from a fresh reset;
    per finished episode, its spawn's bins.  Returns the accumulators on
    the device: ``d_count``, ``d_goals``, ``x_count``, ``x_goals`` (5,)
    and ``modes`` (len(MODES), 5) by distance bin."""
    from rsoccer_tpu_torch.ops.philox import make_key

    dev = benv.device
    structured = benv.unpack_state if benv.fused else (lambda s: s)
    d_edges = torch.tensor(D_EDGES, device=dev)
    x_edges = torch.tensor(X_EDGES, device=dev)
    acc = {k: torch.zeros(5, device=dev) for k in ("d_count", "d_goals", "x_count", "x_goals")}
    acc["modes"] = torch.zeros((len(MODES), 5), device=dev)
    key = make_key(seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    st, obs = benv.reset(key)
    sd, sbx = _spawn_features(structured(st))
    for _ in range(n_steps):
        st, obs, reward, term, trunc, info = benv.step(st, policy(gen, obs), key)
        done = (term | trunc).to(torch.float32)
        succ = done * (reward > 4.0)
        db = torch.searchsorted(d_edges, sd)  # (B,) bin ids 0..4
        xb = torch.searchsorted(x_edges, sbx)
        acc["d_count"].index_add_(0, db, done)
        acc["d_goals"].index_add_(0, db, succ)
        acc["x_count"].index_add_(0, xb, done)
        acc["x_goals"].index_add_(0, xb, succ)
        acc["modes"].index_add_(1, db, torch.stack([info[m] for m in MODES]) * done)
        nd, nx = _spawn_features(structured(st))  # the post-reset state on done lanes
        sd = torch.where(done > 0.5, nd, sd)
        sbx = torch.where(done > 0.5, nx, sbx)
    return acc


def report(acc: dict) -> dict:
    """The JAX tool's JSON from the accumulators."""
    dc, ds, xc, xs, mc = (acc[k].tolist() for k in ("d_count", "d_goals", "x_count", "x_goals", "modes"))
    return {
        "episodes": int(sum(dc)),
        "goal_rate": sum(ds) / max(sum(dc), 1),
        "by_defender_dist": {
            lab: {"episodes": int(c), "goal_rate": s / max(c, 1)} for lab, c, s in zip(LABELS_D, dc, ds)
        },
        "by_ball_x": {
            lab: {"episodes": int(c), "goal_rate": s / max(c, 1)} for lab, c, s in zip(LABELS_X, xc, xs)
        },
        "termination_modes_by_defender_dist": {
            m: {lab: int(mc[i][j]) for j, lab in enumerate(LABELS_D)} for i, m in enumerate(MODES)
        },
    }


def main(argv=None) -> dict:
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch import convert
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.models.ppo import make_policy

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--params", required=True)
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--hidden", default="256,256")
    p.add_argument("--env-kwargs", default="{}")
    p.add_argument("--fused", action="store_true", help="the fused StaticDefenders kernel, kernel RNG")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    env = rt.make("SSLStaticDefenders-v0", **json.loads(args.env_kwargs))
    benv = BatchedEnv(env, args.envs, device=device, fused=args.fused, fused_rng="kernel")
    net, obs_norm = convert.load_ppo_checkpoint(args.params, device=device)
    hidden = tuple(int(h) for h in args.hidden.split(","))
    if net.hidden != hidden:
        raise ValueError(f"--hidden {hidden} but {args.params} holds towers {net.hidden}")
    out = report(spawn_slice(benv, make_policy(net, obs_norm, deterministic=True), args.steps))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
