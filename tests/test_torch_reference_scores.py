"""Scores on the JAX package's own XLA path on the CPU, beside the port's.

Where a published number does not reproduce on the JAX package itself, or
where none is published, the port is held to the JAX package's own score
at the size ``chip_smoke.py`` scores it.  Run as a script, this file
measures those reference numbers on the CPU:

    env -u PYTHONPATH JAX_PLATFORMS=cpu python -m tests.test_torch_reference_scores

- ``sac_sd_cloneseed`` (published 89.4% of 15,029) and the SD expert
  (96.7% of 1,573), which the JAX package scores lower;
- ``sd_bc``, ``sd_sac_bc`` and ``sac_pe_nstep`` (1024 envs x 2400 steps,
  deterministic policy, reference-exact env);
- the Dribbling course lengths of ``drb_ppo``, ``drb_sac`` and the DR
  expert (the reference DR task has no randomness: every episode of a
  deterministic policy is the same course, so its length is the one
  quantity of those runs that can move);
- the league policies ``selfplay_vss_r3`` and ``selfplay_vss_mix`` on the
  ``VSSMultiAgent-v0`` anchor (``tools/vss_anchor_eval.py``: 1024 envs x
  4800 steps, ``PRNGKey(123)``), and the mix at smaller settings, to find
  the one its published 6,580 episodes came from.

Each line it prints is one JSON object (two seeds pooled where a run has
a seed).  As tests, it holds the port's CPU scores of
``sac_sd_cloneseed`` and ``selfplay_vss_r3`` to the JAX package's at a
small size, within the two-sample 3-sigma band.
"""

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch

import rsoccer_tpu
from rsoccer_tpu.batch.vecenv import BatchedEnv as JaxBatchedEnv
from rsoccer_tpu.batch import rollout as JR
from rsoccer_tpu.eval import success_criterion
from rsoccer_tpu.experts import dribbling_expert, static_defenders_expert
from rsoccer_tpu.models.ppo import PPOConfig as JaxPPOConfig
from rsoccer_tpu.models.ppo import PPOTrainer as JaxPPOTrainer
from rsoccer_tpu.models.sac import SquashedGaussianActor
from rsoccer_tpu.utils import checkpoint
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch import make_vec
from rsoccer_tpu_torch.eval import evaluate_policy
from rsoccer_tpu_torch.models import ppo as tppo
from rsoccer_tpu_torch.models import sac as tsac
from rsoccer_tpu_torch.tools.vss_anchor_eval import anchor_eval

torch.set_num_threads(1)

SD = "SSLStaticDefenders-v0"
PE = "SSLPassEndurance-v0"
DR = "SSLDribbling-v0"
MA = "VSSMultiAgent-v0"
ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts")


def jax_score(env_id: str, policy, n_envs: int, n_steps: int, seed: int) -> dict:
    """``policy(key, obs) -> actions`` through the JAX package's
    ``make_eval_fn`` step (its XLA path, ``PRNGKey(seed)``): the finished
    episodes, their successes, and the sum and sum of squares of their
    lengths."""
    env = rsoccer_tpu.make(env_id)
    benv = JaxBatchedEnv(env, n_envs)
    success = success_criterion(env_id)

    def metrics_fn(reward, done, ep_ret, ep_len, info):
        won = done & success(reward, ep_ret, info)
        length = jnp.where(done, ep_len, 0.0)
        return (done.sum(), won.sum(), length.sum(), (length * length).sum())

    one_step = JR.make_step_fn(benv, policy, metrics_fn)

    @jax.jit
    def run(key):
        _, ms = jax.lax.scan(one_step, JR.init_carry(benv, key), None, length=n_steps)
        return jax.tree.map(jnp.sum, ms)

    d, w, ls, lq = run(jax.random.PRNGKey(seed))
    return {"episodes": int(d), "successes": int(w), "length_sum": float(ls), "length_sq_sum": float(lq)}


def jax_sac_policy(name: str, env_id: str):
    """A SAC actor checkpoint, deterministic (``tanh`` of the mean)."""
    env = rsoccer_tpu.make(env_id)
    net = SquashedGaussianActor(action_size=env.action_size)
    like = {"actor_params": net.init(jax.random.PRNGKey(0), jnp.zeros((1, env.obs_size)))}
    params = checkpoint.restore(os.path.join(ARTIFACTS, f"{name}.ckpt.npz"), like=like)["actor_params"]

    def policy(key, obs):
        return jnp.tanh(net.apply(params, obs.T)[0]).T

    return policy


def jax_ppo_policy(name: str, env_id: str, n_envs: int = 1):
    """A ``{params, obs_norm}`` checkpoint through the JAX trainer's
    ``make_policy`` (deterministic; towers (256, 256), flax's bf16), as
    ``tools/vss_anchor_eval.py`` loads one."""
    trainer = JaxPPOTrainer(JaxBatchedEnv(rsoccer_tpu.make(env_id), n_envs), JaxPPOConfig())
    init = trainer.init(jax.random.PRNGKey(0))
    like = {"params": init.params, "obs_norm": init.obs_norm}
    ck = jax.tree.map(jnp.asarray, checkpoint.restore(os.path.join(ARTIFACTS, f"{name}.ckpt.npz"), like=like))
    return trainer.make_policy(ck["params"], ck["obs_norm"], deterministic=True)


def jax_sac_score(name: str, env_id: str, n_envs: int, n_steps: int, seed: int) -> dict:
    """A SAC actor checkpoint, deterministic, through :func:`jax_score`."""
    return jax_score(env_id, jax_sac_policy(name, env_id), n_envs, n_steps, seed)


def jax_anchor(name: str, n_envs: int, n_steps: int, key: int = 123) -> dict:
    """``tools/vss_anchor_eval.py --env-id VSSMultiAgent-v0`` on the JAX
    package: blue and yellow goals and truncations over the finished
    episodes."""
    env = rsoccer_tpu.make(MA)
    benv = JaxBatchedEnv(env, n_envs)
    policy = jax_ppo_policy(name, MA)

    def body(carry, k):
        st, obs = carry
        st, obs, _, term, trunc, info = benv.step(st, policy(k, obs), k)
        done = (term | trunc).astype(jnp.float32)
        return (st, obs), (done.sum(), (done * info["goals_blue"]).sum(),
                           (done * info["goals_yellow"]).sum(), (trunc.astype(jnp.float32) * done).sum())

    @jax.jit
    def run(k):
        kr, ks = jax.random.split(k)
        st, obs = benv.reset(kr)
        _, outs = jax.lax.scan(body, (st, obs), jax.random.split(ks, n_steps))
        return [o.sum() for o in outs]

    eps, gb, gy, tr = map(float, run(jax.random.PRNGKey(key)))
    n = max(eps, 1.0)
    return {"episodes": int(eps), "blue_goal_rate": gb / n, "yellow_goal_rate": gy / n,
            "truncation_rate": tr / n, "mean_goal_diff": (gb - gy) / n}


def jax_sd_expert_score(n_envs: int, n_steps: int, seed: int) -> dict:
    """The SD expert through the JAX package's batched env (auto-reset):
    goals per finished episode, and GK-area entries."""
    env = rsoccer_tpu.make(SD)
    benv = JaxBatchedEnv(env, n_envs)
    expert = jax.vmap(functools.partial(static_defenders_expert, field=env.field),
                      in_axes=-1, out_axes=-1)

    @jax.jit
    def run(key):
        k_reset, k_steps = jax.random.split(key)
        st, _ = benv.reset(k_reset)

        def body(st, k):
            st, _, _, term, trunc, info = benv.step(st, expert(st), k)
            done = term | trunc
            return st, (done.sum(), (done & (info["goal"] > 0.5)).sum(),
                        (done & (info["rbt_in_gk_area"] > 0.5)).sum())

        _, (d, w, g) = jax.lax.scan(body, st, jax.random.split(k_steps, n_steps))
        return d.sum(), w.sum(), g.sum()

    d, w, g = map(int, run(jax.random.PRNGKey(seed)))
    return {"episodes": d, "successes": w, "gk_area_entries": g}


def jax_dr_expert_length(n_envs: int, n_steps: int) -> dict:
    """The DR expert through the JAX package's batched env: finished
    episodes, successes (7 checkpoints) and their lengths."""
    env = rsoccer_tpu.make(DR)
    benv = JaxBatchedEnv(env, n_envs)
    expert = jax.vmap(dribbling_expert, in_axes=-1, out_axes=-1)

    @jax.jit
    def run(key):
        st, _ = benv.reset(key)

        def body(carry, k):
            st, ep_ret, ep_len = carry
            st, _, r, term, trunc, _ = benv.step(st, expert(st), k)
            done = term | trunc
            ep_ret, ep_len = ep_ret + r, ep_len + 1.0
            length = jnp.where(done, ep_len, 0.0)
            won = done & (ep_ret >= 6.5)  # eval.py's DR success: all 7 checkpoints
            return ((st, jnp.where(done, 0.0, ep_ret), jnp.where(done, 0.0, ep_len)),
                    (done.sum(), won.sum(), length.sum(), (length * length).sum()))

        zeros = jnp.zeros((n_envs,))
        _, ms = jax.lax.scan(body, (st, zeros, zeros), jax.random.split(key, n_steps))
        return [m.sum() for m in ms]

    d, w, ls, lq = run(jax.random.PRNGKey(0))
    return {"episodes": int(d), "successes": int(w), "length_sum": float(ls), "length_sq_sum": float(lq)}


def two_sample_band(p: float, n_ref: int, n: int) -> tuple:
    half = 3.0 * math.sqrt(p * (1 - p) * (1.0 / n_ref + 1.0 / n))
    return p - half, p + half


def test_cloneseed_port_scores_as_the_jax_package():
    """sac_sd_cloneseed at 128 envs x 1200 steps: the port's CPU success
    rate (fused path, plain version) inside the two-sample 3-sigma band
    around the JAX package's on its XLA path."""
    want = jax_sac_score("sac_sd_cloneseed", SD, 128, 1200, seed=0)
    actor = convert.load_sac_checkpoint(os.path.join(ARTIFACTS, "sac_sd_cloneseed.ckpt.npz"), device="cpu")
    got = evaluate_policy(SD, tsac.make_policy(actor), n_envs=128, n_steps=1200, device="cpu", fused=True)
    p_ref = want["successes"] / want["episodes"]
    lo, hi = two_sample_band(p_ref, want["episodes"], got["episodes"])
    print(f"sac_sd_cloneseed: port {got['success_rate']:.4f} of {got['episodes']}, "
          f"JAX {p_ref:.4f} of {want['episodes']}")
    assert want["episodes"] >= 500 and got["episodes"] >= 500
    assert lo <= got["success_rate"] <= hi


def test_league_anchor_port_scores_as_the_jax_package():
    """selfplay_vss_r3 on the VSSMultiAgent-v0 anchor at 128 envs x 1200
    steps: the port's CPU blue goal rate (the fused_physics path's plain
    version, which the card runs through K2) inside the two-sample 3-sigma
    band around the JAX package's."""
    want = jax_anchor("selfplay_vss_r3", 128, 1200)
    benv = make_vec(MA, 128, device="cpu", fused_physics=True)
    net, obs_norm = convert.load_ppo_checkpoint(os.path.join(ARTIFACTS, "selfplay_vss_r3.ckpt.npz"),
                                                device="cpu")
    got = anchor_eval(benv, tppo.make_policy(net, obs_norm, deterministic=True), 1200)
    p_ref = want["blue_goal_rate"]
    lo, hi = two_sample_band(p_ref, want["episodes"], got["episodes"])
    print(f"selfplay_vss_r3: port {got} JAX {want}")
    assert want["episodes"] >= 150 and got["episodes"] >= 150
    assert lo <= got["blue_goal_rate"] <= hi


@pytest.mark.parametrize("name,fmt", [("drb_ppo", "ppo"), ("drb_sac", "sac")])
def test_dribbling_course_port_near_the_jax_package(name, fmt):
    """The reference Dribbling task draws no noise, so a deterministic
    policy runs one course, and its length is what chip_smoke.py gates
    (within 5% of the JAX package's).  On the CPU the port's course equals
    the JAX package's for drb_ppo (217 steps) and is 246 steps against 249
    for drb_sac: the closed loop carries the two implementations' f32
    rounding (1e-7 apart after the first step) forward until the policy
    takes a step of its course at another time."""
    path = os.path.join(ARTIFACTS, f"{name}.ckpt.npz")
    j_pol = jax_ppo_policy(name, DR) if fmt == "ppo" else jax_sac_policy(name, DR)
    want = jax_score(DR, j_pol, 2, 600, 0)
    t_pol = (tppo.make_policy(*convert.load_ppo_checkpoint(path, device="cpu")) if fmt == "ppo"
             else tsac.make_policy(convert.load_sac_checkpoint(path, device="cpu")))
    got = evaluate_policy(DR, t_pol, n_envs=2, n_steps=600, device="cpu", fused=True)
    ref = want["length_sum"] / want["episodes"]
    assert want["successes"] == want["episodes"] >= 2 and got["success_rate"] == 1.0
    assert abs(got["mean_episode_length"] - ref) <= 0.05 * ref
    if name == "drb_ppo":
        assert got["mean_episode_length"] == ref


def pooled(name: str, runs: list) -> dict:
    eps, won = sum(r["episodes"] for r in runs), sum(r["successes"] for r in runs)
    out = {"name": name, "runs": runs, "episodes": eps, "successes": won, "success_rate": won / eps}
    if "length_sum" in runs[0]:
        ls, lq = sum(r["length_sum"] for r in runs), sum(r["length_sq_sum"] for r in runs)
        out.update(mean_episode_length=ls / eps, episode_length_var=max(lq / eps - (ls / eps) ** 2, 0.0))
    return out


def main() -> int:
    """The reference numbers at chip_smoke.py's sizes, two seeds each where
    a run draws noise, pooled; one JSON line each."""
    platform = jax.devices()[0].platform
    seeds = (0, 1)

    def emit(out):
        print(json.dumps({**out, "platform": platform}), flush=True)

    emit(pooled("sac_sd_cloneseed", [jax_sac_score("sac_sd_cloneseed", SD, 1024, 2400, s) for s in seeds]))
    emit(pooled("sd_expert", [jax_sd_expert_score(1024, 2000, s) for s in seeds]))
    for name, fmt, env_id in (("sd_bc", "ppo", SD), ("sd_sac_bc", "sac", SD), ("sac_pe_nstep", "sac", PE)):
        policy = jax_ppo_policy(name, env_id) if fmt == "ppo" else jax_sac_policy(name, env_id)
        emit(pooled(name, [jax_score(env_id, policy, 1024, 2400, s) for s in seeds]))
    # Dribbling: no randomness, every env runs the same course; 8 envs
    # for chip_smoke.py's 9600 steps
    emit(pooled("drb_ppo", [jax_score(DR, jax_ppo_policy("drb_ppo", DR), 8, 9600, 0)]))
    emit(pooled("drb_sac", [jax_score(DR, jax_sac_policy("drb_sac", DR), 8, 9600, 0)]))
    emit(pooled("dr_expert", [jax_dr_expert_length(8, 9600)]))
    for name in ("selfplay_vss_r3", "selfplay_vss_mix"):
        emit({"name": name, "env_id": MA, "envs": 1024, "steps": 4800, **jax_anchor(name, 1024, 4800)})
    # the settings the mix's published 6,580 episodes may come from: the
    # example's own anchor gate (512 x 1500) and a few of its multiples
    for envs, steps in ((512, 1500), (1024, 1500), (512, 3600), (1024, 1800), (2048, 900)):
        emit({"name": "selfplay_vss_mix", "env_id": MA, "envs": envs, "steps": steps,
              **jax_anchor("selfplay_vss_mix", envs, steps)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
