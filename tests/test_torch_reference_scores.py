"""Scores on the JAX package's own XLA path on the CPU, where a published
number does not reproduce there, beside the port's.

``artifacts/README.md`` gives ``sac_sd_cloneseed`` 89.4% of 15,029
episodes and ``docs/training.md`` the SD expert 96.7% of 1,573; the JAX
package, evaluated as ``chip_smoke.py`` evaluates the port (1024 envs,
reference-exact env, deterministic policy), scores both lower.  Run as a
script, this file measures those reference numbers (``chip_smoke.py``'s
``bc_checkpoints`` holds the port to the first):

    env -u PYTHONPATH JAX_PLATFORMS=cpu python -m tests.test_torch_reference_scores

As a test it holds the port's CPU score of ``sac_sd_cloneseed`` to the
JAX package's at a small size, within the two-sample 3-sigma band.
"""

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import torch

import rsoccer_tpu
from rsoccer_tpu.batch.vecenv import BatchedEnv as JaxBatchedEnv
from rsoccer_tpu.eval import make_eval_fn, success_criterion
from rsoccer_tpu.experts import static_defenders_expert
from rsoccer_tpu.models.sac import SquashedGaussianActor
from rsoccer_tpu.utils import checkpoint
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.eval import evaluate_policy
from rsoccer_tpu_torch.models import sac as tsac

torch.set_num_threads(1)

SD = "SSLStaticDefenders-v0"
ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts")


def jax_sac_score(name: str, env_id: str, n_envs: int, n_steps: int, seed: int) -> dict:
    """A SAC actor checkpoint, deterministic (``tanh`` of the mean), through
    the JAX package's ``make_eval_fn`` on its XLA path."""
    env = rsoccer_tpu.make(env_id)
    net = SquashedGaussianActor(action_size=env.action_size)
    like = {"actor_params": net.init(jax.random.PRNGKey(0), jnp.zeros((1, env.obs_size)))}
    params = checkpoint.restore(os.path.join(ARTIFACTS, f"{name}.ckpt.npz"), like=like)["actor_params"]

    def policy(key, obs):
        return jnp.tanh(net.apply(params, obs.T)[0]).T

    ms = jax.jit(make_eval_fn(JaxBatchedEnv(env, n_envs), n_steps, policy,
                              success_criterion(env_id)))(jax.random.PRNGKey(seed))
    return {"episodes": int(ms.episodes), "successes": int(ms.successes)}


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


def main() -> int:
    """The reference numbers at chip_smoke.py's sizes, two seeds each, and
    the pooled rate."""
    runs = {
        "sac_sd_cloneseed": [jax_sac_score("sac_sd_cloneseed", SD, 1024, 2400, s) for s in (0, 1)],
        "sd_expert": [jax_sd_expert_score(1024, 2000, s) for s in (0, 1)],
    }
    for name, rs in runs.items():
        eps, won = sum(r["episodes"] for r in rs), sum(r["successes"] for r in rs)
        print(json.dumps({"name": name, "runs": rs, "episodes": eps, "successes": won,
                          "success_rate": won / eps, "platform": jax.devices()[0].platform}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
