"""The port's multi-process runs on the CPU (gloo, a FileStore), mirroring
``tests/test_distributed.py``: ``rsoccer_tpu_torch/tools/distributed_smoke.py``
at two ranks against one rank, each rank a process with its own timeout,
at that test's tolerances.

A rank is a device here, so the JAX test's "2 processes x 4 devices
against 1 process x 8" (one program on one mesh) becomes, per ``--impl``:
``jit`` and ``ppo`` two ranks against one (the sharded programs equal the
unsharded one: rel 1e-4 and 1e-5, f32 towers for PPO); ``shard_map`` and
``sac``, whose shards are per-rank programs, two ranks against a replay of
those two shards (``shard_map``) or against the JAX package's
``make_sharded_sac`` on a 2-device mesh fed the same per-shard draws
(``sac``).  At one rank each sharded entry point is the unsharded one, bit
for bit."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch as rt
from rsoccer_tpu.batch.vecenv import BatchedEnv as JaxBatchedEnv
from rsoccer_tpu.envs.base import draw_noise as jax_draw_noise
from rsoccer_tpu.models import sac as jsac
from rsoccer_tpu.parallel.mesh import make_env_mesh as jax_env_mesh
from rsoccer_tpu.parallel.sac import make_sharded_sac as jax_make_sharded_sac, shard_sac_state
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.envs.ssl_static_defenders import SDState
from rsoccer_tpu_torch.models import sac as tsac
from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer
from rsoccer_tpu_torch.tools.distributed_smoke import param_digest
from rsoccer_tpu_torch.utils import checkpoint
from tests.torch_dist_worker import shard_map_replay, spawn, start

torch.set_num_threads(1)

TIMEOUT = 120  # seconds, each rank


def start_smoke(impl: str, world: int, tmp_path, *extra):
    """Start the tool on ``world`` ranks (processes); returns ``finish()``,
    which waits for them and returns rank 0's JSON line."""
    store = tmp_path / f"store_{impl}_{world}_{'_'.join(extra)}"
    wait = spawn([["rsoccer_tpu_torch.tools.distributed_smoke", "--impl", impl, "--world-size", str(world),
                   "--rank", str(r), "--init-method", f"file://{store}", "--backend", "gloo", "--device", "cpu",
                   *extra] for r in range(world)], TIMEOUT)

    def finish() -> dict:
        outs = wait()
        for rc, _, err in outs:
            assert rc == 0, f"rank failed:\n{err[-3000:]}"
        return json.loads(outs[0][1].strip().splitlines()[-1])

    return finish


def two_and_one(impl: str, tmp_path, *extra):
    """The tool on two ranks and on one, run side by side: (two, one)."""
    runs = [start_smoke(impl, world, tmp_path, *extra) for world in (2, 1)]
    return tuple(finish() for finish in runs)


def test_two_rank_rollout_matches_one_rank(tmp_path):
    multi, single = two_and_one("jit", tmp_path)
    assert multi["global_devices"] == multi["num_processes"] == 2 and single["global_devices"] == 1
    assert multi["episodes"] == single["episodes"]
    assert multi["total_reward"] == pytest.approx(single["total_reward"], rel=1e-5)
    assert multi["obs_sum"] == pytest.approx(single["obs_sum"], rel=1e-5)


@pytest.mark.parametrize("world", [1, 2])
def test_shard_map_rollout_matches_its_shards(tmp_path, world):
    """The per-shard rollout on ``world`` ranks against the one-process
    replay of its shards (keys folded with the rank)."""
    got = start_smoke("shard_map", world, tmp_path)()
    benv = rt.make_vec("VSS-v0", 64, device="cpu")
    carries, metrics = shard_map_replay(benv, world, 50, 0, calls=1)
    total_reward, episodes, _, length_sum = metrics[0].tolist()
    assert got["episodes"] == int(episodes)
    assert got["total_reward"] == pytest.approx(total_reward, rel=1e-5)
    assert got["episode_length_sum"] == pytest.approx(length_sum, rel=1e-5)
    obs_sum = sum(float(c.obs.abs().sum()) for c in carries)
    assert got["obs_sum"] == pytest.approx(obs_sum, rel=1e-5)


@pytest.mark.parametrize("mode", ["shuffle", "time"])
def test_two_rank_ppo_train_step_matches_one_rank(tmp_path, mode):
    """Two full sharded PPO train steps on two ranks against one rank:
    the same losses, params and obs at the JAX test's tolerances (f32
    towers), and the params bit-identical on both ranks."""
    extra = ("--towers", "f32", "--minibatch-mode", mode)
    multi, single = two_and_one("ppo", tmp_path, *extra)
    assert multi["params_equal_across_ranks"]
    assert multi["loss"] == pytest.approx(single["loss"], rel=1e-4)
    assert multi["mean_reward"] == pytest.approx(single["mean_reward"], rel=1e-4)
    assert multi["param_checksum"] == pytest.approx(single["param_checksum"], rel=1e-5)
    assert multi["obs_sum"] == pytest.approx(single["obs_sum"], rel=1e-5)


def test_one_rank_ppo_is_the_unsharded_trainer(tmp_path):
    """At one rank the sharded PPO (bf16 towers, the JAX tool's recipe)
    gives the unsharded PPOTrainer's params bit for bit."""
    finish = start_smoke("ppo", 1, tmp_path)
    trainer = PPOTrainer(rt.make_vec("VSS-v0", 64, device="cpu"),
                         PPOConfig(rollout_steps=8, num_epochs=2, num_minibatches=2))
    state = trainer.init(0)
    for _ in range(2):
        state, metrics = trainer.train_step(state)
    single = finish()
    assert single["param_digest"] == param_digest([state.net])
    assert single["loss"] == float(metrics["loss"])


def test_two_rank_sac_keeps_the_networks_replicated(tmp_path):
    """Ten sharded SAC iterations on two ranks: the networks bit-identical
    on both, each ring holding 10 x 32 local transitions, finite losses;
    at one rank, the unsharded SACTrainer's networks bit for bit."""
    runs = [start_smoke("sac", world, tmp_path) for world in (2, 1)]
    trainer = tsac.SACTrainer(rt.make_vec("VSS-v0", 64, device="cpu"),
                              tsac.SACConfig(buffer_size=64 * 16, batch_size=64, warmup_steps=2, n_step=3))
    state = trainer.init(0)
    for i in range(10):
        state, metrics = trainer.train_step(state, tsac.iteration_generator(0, i, "cpu"))
    multi, single = (finish() for finish in runs)
    assert multi["params_equal_across_ranks"] and multi["filled_local"] == 10 * 32
    assert all(np.isfinite(multi[k]) for k in ("q_loss", "alpha", "mean_reward"))
    assert single["filled_local"] == state.buffer.filled == 640
    assert single["param_digest"] == param_digest([state.actor, state.qs, state.qs_target])
    assert single["q_loss"] == float(metrics["q_loss"])


# ------------------------------------------------- sharded SAC against the JAX package

ENV_ID = "SSLStaticDefenders-v0"
B, W = 16, 2  # global envs, ranks (devices)
HIDDEN = (32, 32)
PARAM_ATOL = 1e-5  # tests/test_torch_sac.py's
# global sizes (each rank: a ring of 64, a minibatch of 32, 8 envs); warmup
# for two iterations, then learning with two gradient steps each
CFG = dict(buffer_size=128, batch_size=64, warmup_steps=2, n_step=3, grad_steps_per_iter=2, gamma=0.995,
           reward_scale=10.0, target_entropy_scale=0.5)
N_ITERS = 5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t_(a):
    return torch.from_numpy(np.array(a))


def shard_draws(jtr, key, it: int) -> dict:
    """What the JAX ``train_step(state, key)`` of one shard draws at
    iteration ``it``, as the .npz entries the rank reads: the collect's
    normals, uniforms and env noise (``c{it}_*``), then each update's
    offsets and normals (``u{n}_*``, ``n`` counting updates over the run)."""
    cfg, b, act = jtr.cfg, jtr.benv.n_envs, jtr.benv.action_size
    out = {}
    key, k = jax.random.split(key)
    k_act, k_env = jax.random.split(k)
    kt, kr = jax.random.split(k_env)
    out[f"c{it}_normal"] = np.asarray(jax.random.normal(k_act, (b, act)))
    out[f"c{it}_uniform"] = np.asarray(jax.random.uniform(k_act, (b, act), minval=-1.0, maxval=1.0))
    for tag, kk, spec in (("t", kt, jtr.benv._t_spec), ("r", kr, jtr.benv._r_spec)):
        for name, v in jax_draw_noise(kk, spec, batch=b).items():
            out[f"c{it}_{tag}_{name}"] = np.asarray(v)
    filled = min((it + 1) * b, cfg.buffer_size)  # the ring after this iteration's collect
    valid = max(filled - (cfg.n_step - 1) * b, 1)
    for j in range(cfg.grad_steps_per_iter):
        key, k = jax.random.split(key)
        k_s, k_next, k_pi = jax.random.split(k, 3)
        n = it * cfg.grad_steps_per_iter + j
        out[f"u{n}_offsets"] = np.asarray(jax.random.randint(k_s, (cfg.batch_size,), 0, valid))
        out[f"u{n}_next_eps"] = np.asarray(jax.random.normal(k_next, (cfg.batch_size, act)))
        out[f"u{n}_pi_eps"] = np.asarray(jax.random.normal(k_pi, (cfg.batch_size, act)))
    return out


def port_shard_state(ttr, jstate, rank: int) -> tsac.SACState:
    """Rank ``rank``'s port SACState equal to its shard of the JAX global
    init: the replicated networks, fresh Adam states, an empty local ring,
    its columns of the env state and obs."""
    cols = slice(rank * ttr.benv.n_envs, (rank + 1) * ttr.benv.n_envs)
    leaves = lambda p: [np.asarray(x) for x in jax.tree.leaves(p)]  # noqa: E731
    actor = convert.sac_actor_from_leaves(leaves(jstate.actor_params), device="cpu")
    qs, qs_target = (convert.sac_critics_from_leaves(leaves(p), ttr.benv.obs_size, device="cpu")
                     for p in (jstate.qs_params, jstate.qs_target))
    log_alpha = t_(jstate.log_alpha).requires_grad_(True)
    env_state = convert.state_from_numpy(jax.tree.map(lambda x: np.asarray(x)[..., cols], jstate.env_state),
                                         SDState, device="cpu")
    return tsac.SACState(
        actor=actor, qs=qs, qs_target=qs_target, log_alpha=log_alpha,
        opt_actor=ttr.make_optimizer(actor.parameters()), opt_qs=ttr.make_optimizer(qs.parameters()),
        opt_alpha=ttr.make_optimizer([log_alpha]),
        buffer=tsac.Buffer(ttr.cfg.buffer_size, ttr.benv.obs_size, ttr.benv.action_size, "cpu"),
        env_state=env_state, obs=t_(np.asarray(jstate.obs)[:, cols]), env_key=torch.tensor([1, 2, 0]),
        total_steps=0, iteration=0,
    )


def assert_trees_close(got, want, atol, tag):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(paths)
    for (path, w), g in zip(paths, got_leaves):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=atol,
                                   err_msg=f"{tag}{jax.tree_util.keystr(path)}")


def test_sharded_sac_matches_jax_make_sharded_sac(tmp_path, monkeypatch):
    """The port's make_sharded_sac on two ranks against the JAX package's
    on a 2-device mesh, SSLStaticDefenders-v0 at 16 envs (8 per shard),
    five iterations (two of warmup) from the same state, each shard fed
    the draws its ``fold_in(key, idx)`` splits give: the replicated
    networks at tests/test_torch_sac.py's PARAM_ATOL, each ring's count
    exactly."""
    monkeypatch.setattr(jsac, "SquashedGaussianActor", functools.partial(jsac.SquashedGaussianActor, hidden=HIDDEN))
    monkeypatch.setattr(jsac, "QCritic", functools.partial(jsac.QCritic, hidden=HIDDEN))
    if len(jax.devices()) < W:
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_count >= 2")
    jbenv = JaxBatchedEnv(rsoccer_tpu.make(ENV_ID), B)
    mesh = jax_env_mesh(W)
    jlocal, _, jstep = jax_make_sharded_sac(jbenv, jsac.SACConfig(**CFG), mesh)
    # make_sharded_sac's init, with the global init under jit (eager, it
    # dispatches the SD reset op by op)
    state = shard_sac_state(jax.jit(jsac.SACTrainer(jbenv, jsac.SACConfig(**CFG)).init)(jax.random.PRNGKey(0)), mesh)
    state0 = jax.tree.map(np.asarray, state)

    ttr = tsac.SACTrainer(BatchedEnv(rt.make(ENV_ID), B // W, device="cpu"),
                          tsac.SACConfig(**{**CFG, "buffer_size": CFG["buffer_size"] // W,
                                            "batch_size": CFG["batch_size"] // W}, hidden=HIDDEN))
    spec = dict(env_id=ENV_ID, envs=B, cfg=CFG, hidden=list(HIDDEN), iters=N_ITERS,
                state=str(tmp_path / "state{rank}"), draws=str(tmp_path / "draws{rank}.npz"))
    for r in range(W):
        checkpoint.save(spec["state"].format(rank=r), ttr.state_tree(port_shard_state(ttr, state0, r)))
        entries = {}
        for i in range(N_ITERS):
            key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(1), i), r)
            entries.update(shard_draws(jlocal, key, i))
        np.savez(spec["draws"].format(rank=r), **entries)
    spec["t_names"] = sorted(jax_draw_noise(jax.random.PRNGKey(0), jbenv._t_spec, batch=1))
    spec["r_names"] = sorted(jax_draw_noise(jax.random.PRNGKey(0), jbenv._r_spec, batch=1))
    finish = start("sac_fed", W, spec, tmp_path)  # the ranks run while JAX compiles its step

    step = jax.jit(jstep)
    for i in range(N_ITERS):
        state, metrics = step(state, jax.random.fold_in(jax.random.PRNGKey(1), i))
    ranks = finish()
    for rank in ranks:
        for name, want in (("actor", state.actor_params), ("qs", state.qs_params),
                           ("qs_target", state.qs_target)):
            assert_trees_close(rank[name], np_tree(want), PARAM_ATOL, f"{name} ")
        np.testing.assert_allclose(float(rank["log_alpha"]), float(state.log_alpha), rtol=0, atol=PARAM_ATOL)
        assert rank["filled"] == int(state.buffer.filled) == N_ITERS * (B // W)
        for k in ("q_loss", "actor_loss", "alpha", "mean_reward"):
            assert rank["metrics"][k] == pytest.approx(float(metrics[k]), rel=1e-4, abs=1e-6), k
    # the networks moved, and stayed replicated across the ranks
    assert not np.allclose(np.asarray(jax.tree.leaves(state.actor_params)[0]),
                           np.asarray(jax.tree.leaves(state0.actor_params)[0]))
    for a, b in zip(jax.tree.leaves(ranks[0]["actor"]), jax.tree.leaves(ranks[1]["actor"])):
        assert np.array_equal(a, b)
