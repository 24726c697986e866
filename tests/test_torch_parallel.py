"""The port's data-parallel layer (``rsoccer_tpu_torch/parallel/``) on the
CPU: the Philox counter's ``env_base`` (a shard's draws are the unsharded
batch's columns, on every draw path), the mesh helpers and their
divisibility errors (``tests/test_sharding.py``'s counterparts), the
sharded rollout at two ranks against the unsharded one env for env (plain
path, both RNG modes), the per-shard (``shard_map``) variant, and the
sharded PPO's moment merge and minibatch split, and the learners' common
start (every rank's networks the first rank's).  Ranks are processes over
gloo (``tests/torch_dist_worker.py``)."""

import numpy as np
import pytest
import torch

import rsoccer_tpu_torch as rt
from rsoccer_tpu_torch.batch import rollout as R
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.envs.base import draw_noise, step_noise_spec
from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer
from rsoccer_tpu_torch.models.sac import SACConfig
from rsoccer_tpu_torch.ops import ssl_full as sf
from rsoccer_tpu_torch.ops import vss_full as vf
from rsoccer_tpu_torch.ops.philox import fold_in, make_key, philox_words
from rsoccer_tpu_torch.parallel import mesh as M
from rsoccer_tpu_torch.parallel import ppo as dp
from rsoccer_tpu_torch.parallel.rollout import (
    make_shard_map_rollout, make_sharded_rollout,
)
from rsoccer_tpu_torch.parallel.sac import make_sharded_sac
from tests.torch_dist_worker import fake_mesh, launch, shard_map_replay, stacked

torch.set_num_threads(1)

TASKS = ["VSS-v0", "SSLStaticDefenders-v0", "SSLContestedPossession-v0", "SSLDribbling-v0",
         "SSLPassEndurance-v0"]
# the unsharded batch; a shard's first env and width.  Multiples of 16: on
# the CPU torch runs element-wise ops in 16-float vectors (AVX-512) and a
# tail loop that differs in the last bit for atan2 and the like, so a
# column is bit-stable only where both batches cut it into the same vectors
B, BASE, N = 64, 16, 32


def keyed(step=7):
    key = make_key(11, stream=2, device="cpu")
    key[2] = (1 << 32) + step  # both step words in play
    return key


# ---------------------------------------------------------------- env_base

def test_philox_words_at_env_base_are_the_columns():
    key = keyed()
    want = philox_words(key, 37, B)
    got = philox_words(key, 37, N, env_base=BASE)
    assert torch.equal(got, want[:, BASE:BASE + N])
    assert not torch.equal(got, want[:, :N])
    with pytest.raises(ValueError, match="env counter"):
        philox_words(key, 4, 8, env_base=(1 << 32) - 4)


@pytest.mark.parametrize("env_id", TASKS)
def test_draws_at_env_base_are_the_columns(env_id):
    """draw_noise, the fused steps' plain row draws and BatchedEnv.reset, at
    env_base BASE: columns [BASE, BASE + N) of the unsharded batch's, and
    the key advanced alike."""
    env = rt.make(env_id)
    spec = step_noise_spec(env)
    k1, k2 = keyed(), keyed()
    want = draw_noise(k1, spec, B)
    got = draw_noise(k2, spec, N, env_base=BASE)
    assert torch.equal(k1, k2)
    assert list(got) == list(want)
    for name in want:
        assert torch.equal(got[name], want[name][..., BASE:BASE + N]), name
    draw = {"VSS-v0": vf.draw_step_rows, "SSLStaticDefenders-v0": sf.sd_draw_step_rows,
            "SSLContestedPossession-v0": sf.cp_draw_step_rows, "SSLDribbling-v0": sf.dr_draw_step_rows,
            "SSLPassEndurance-v0": sf.pe_draw_step_rows}[env_id]
    rows_w, rows_g = draw(env, keyed(), B), draw(env, keyed(), N, BASE)
    assert len(rows_w) == len(rows_g)
    for w, g in zip(rows_w, rows_g):
        assert torch.equal(g, w[..., BASE:BASE + N])
    full = BatchedEnv(env, B, device="cpu", fused=True)
    shard = BatchedEnv(env, N, device="cpu", fused=True, env_base=BASE)
    st_w, obs_w = full.reset(keyed())
    st_g, obs_g = shard.reset(keyed())
    assert torch.equal(st_g, st_w[:, BASE:BASE + N]) and torch.equal(obs_g, obs_w[:, BASE:BASE + N])


@pytest.mark.parametrize("env_id", TASKS)
@pytest.mark.parametrize("fused_rng", ["input", "kernel"])
def test_fused_steps_at_env_base_are_the_columns(env_id, fused_rng):
    """Five fused steps (the plain versions on the CPU) of a shard at
    env_base BASE through auto-resets (a step limit of 2) equal those
    columns of the unsharded batch's, state, obs and aux, bit for bit."""
    env = rt.make(env_id)
    env.max_episode_steps = 2
    full = BatchedEnv(env, B, device="cpu", fused=True, fused_rng=fused_rng)
    shard = BatchedEnv(env, N, device="cpu", fused=True, fused_rng=fused_rng, env_base=BASE)
    kf, ks = keyed(), keyed()
    st_f, _ = full.reset(kf)
    st_s, _ = shard.reset(ks)
    gen = torch.Generator().manual_seed(3)
    for _ in range(5):
        act = torch.rand((env.action_size, B), generator=gen) * 2 - 1
        out_f = full.step_final(st_f, act, kf)
        out_s = shard.step_final(st_s, act[:, BASE:BASE + N].contiguous(), ks)
        st_f, st_s = out_f[0], out_s[0]
        for w, g in zip(out_f[:6], out_s[:6]):
            assert torch.equal(g, w[..., BASE:BASE + N])
    assert torch.equal(kf, ks)


# ---------------------------------------------------------------- mesh helpers

def test_mesh_helpers_shard_the_trailing_axis():
    env = rt.make("VSS-v0")
    benv = BatchedEnv(env, 12, device="cpu")
    st, obs = benv.reset(make_key(0, device="cpu"))
    for rank in range(3):
        mesh = fake_mesh(rank, 3)
        sl = M.batch_slice(mesh, 12)
        assert (sl.start, sl.stop) == (4 * rank, 4 * rank + 4)
        shard = M.shard_batched_tree({"st": st, "obs": obs, "n": 5}, mesh)
        assert shard["n"] == 5 and shard["obs"].shape == (env.obs_size, 4)
        assert shard["obs"].is_contiguous() and torch.equal(shard["obs"], obs[:, sl])
        assert torch.equal(shard["st"].world.robots.v_wheel, st.world.robots.v_wheel[..., sl])
        lb = M.local_benv(benv, mesh)
        assert (lb.n_envs, lb.env_base, lb.fused, lb.env) == (4, 4 * rank, False, env)
    assert M.ENV_AXIS == fake_mesh(0, 1).axis == "env"


def test_indivisible_sizes_rejected():
    """tests/test_sharding.py's indivisible batch and SAC sizes."""
    env = rt.make("VSS-v0")
    mesh = fake_mesh(0, 8)
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        make_sharded_rollout(BatchedEnv(env, 63, device="cpu"), mesh, 5)
    with pytest.raises(ValueError, match="not divisible"):
        make_shard_map_rollout(BatchedEnv(env, 63, device="cpu"), mesh, 5)
    with pytest.raises(ValueError, match="n_envs=30"):
        make_sharded_sac(BatchedEnv(env, 30, device="cpu"), SACConfig(), mesh)
    with pytest.raises(ValueError, match="batch_size=60"):
        make_sharded_sac(BatchedEnv(env, 32, device="cpu"), SACConfig(batch_size=60), mesh)
    with pytest.raises(ValueError, match="n_envs=63"):
        PPOTrainer(BatchedEnv(env, 63, device="cpu"), PPOConfig(), mesh=mesh)


def test_make_env_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_env_mesh("cpu")


# ---------------------------------------------------------------- sharded rollouts

ROLL = dict(env_id="VSS-v0", envs=32, steps=12, seed=5)


@pytest.mark.parametrize("fused,fused_rng", [(False, "input"), (True, "input"), (True, "kernel")],
                         ids=["unfused", "fused_input", "fused_kernel"])
def test_sharded_rollout_two_ranks_equal_unsharded(tmp_path, fused, fused_rng):
    """Two ranks of make_sharded_rollout, two calls: their states and obs,
    concatenated, are the unsharded rollout's bit for bit, the metrics the
    same to rel 1e-6, the key advanced alike."""
    spec = dict(ROLL, impl="jit", fused=fused, fused_rng=fused_rng)
    ranks = launch("rollout", 2, spec, tmp_path)
    benv = rt.make_vec("VSS-v0", ROLL["envs"], device="cpu", fused=fused, fused_rng=fused_rng)
    roll = R.make_rollout_fn(benv, ROLL["steps"])
    carry, m1 = roll(R.init_carry(benv, ROLL["seed"]))
    carry, m2 = roll(carry)
    cat = torch.cat([r["obs"] for r in ranks], dim=-1)
    assert torch.equal(cat, carry.obs)
    if fused:
        assert torch.equal(torch.cat([r["state"] for r in ranks], dim=-1), carry.state)
    else:
        for a, *shards in zip(_leaves(carry.state), *(_leaves(r["state"]) for r in ranks)):
            assert torch.equal(torch.cat(shards, dim=-1), a)
    for r in ranks:
        assert torch.equal(r["key"], carry.key)
        for got, want in zip(r["metrics"], (m1, m2)):
            np.testing.assert_allclose(got.numpy(), stacked(want).numpy(), rtol=1e-6, atol=1e-6)
    assert float(m1.total_reward) != 0.0


INIT = {"sac": dict(env_id="VSS-v0", envs=32, hidden=[16, 16], cfg=dict(buffer_size=64, batch_size=16)),
        "ppo": dict(env_id="VSS-v0", envs=32, hidden=[16, 16], cfg=dict(rollout_steps=8, num_minibatches=2))}


@pytest.mark.parametrize("learner", ["sac", "ppo"])
def test_replicas_start_from_the_first_ranks_networks(tmp_path, learner):
    """Two ranks of the sharded SAC / PPO, each rank's init given its own
    seed (its rank): both end with the networks the unsharded trainer
    draws from seed 0, bit for bit; seed 1's draws differ from them."""
    spec = dict(INIT[learner], learner=learner)
    ranks = launch("init", 2, spec, tmp_path)
    benv = rt.make_vec(spec["env_id"], spec["envs"], device="cpu")
    hidden = tuple(spec["hidden"])
    if learner == "sac":
        from rsoccer_tpu_torch.models.sac import SACTrainer

        trainer = SACTrainer(benv, SACConfig(**spec["cfg"], hidden=hidden))

        def params(seed):
            st = trainer.init(seed)
            return [p for m in (st.actor, st.qs, st.qs_target) for p in m.parameters()]
    else:
        trainer = PPOTrainer(benv, PPOConfig(**spec["cfg"], hidden=hidden))

        def params(seed):
            return list(trainer.init(seed).net.parameters())
    want = params(0)
    assert not all(torch.equal(a, b) for a, b in zip(params(1), want))
    for r in ranks:
        assert len(r["params"]) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(r["params"], want))


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def test_shard_map_rollout_folds_the_rank(tmp_path):
    """Two ranks of make_shard_map_rollout, two calls: each shard equals
    its one-process replay (keys folded with the rank) bit for bit; the
    shards' draws differ from the sharded (jit) rollout's; the key comes
    back replicated; the metrics are the shards' sums."""
    spec = dict(ROLL, impl="shard_map", fused=True, fused_rng="kernel")
    ranks = launch("rollout", 2, spec, tmp_path)
    benv = rt.make_vec("VSS-v0", ROLL["envs"], device="cpu", fused=True, fused_rng="kernel")
    carries, metrics = shard_map_replay(benv, 2, ROLL["steps"], ROLL["seed"])
    for r, rank in enumerate(ranks):
        assert torch.equal(rank["state"], carries[r].state) and torch.equal(rank["obs"], carries[r].obs)
        assert torch.equal(rank["key"], ranks[0]["key"])
        for got, want in zip(rank["metrics"], metrics):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    # independent streams: shard 1 drew other words than its jit counterpart
    roll = R.make_rollout_fn(benv, ROLL["steps"])
    c, _ = roll(R.init_carry(benv, ROLL["seed"]))
    c, _ = roll(c)
    assert not torch.equal(ranks[1]["obs"], c.obs[:, 16:])
    assert not torch.equal(ranks[0]["state"], ranks[1]["state"])
    # the replicated key: rank 0's folded stream, advanced by both calls
    want_key = fold_in(fold_in(make_key(ROLL["seed"], device="cpu"), 0), 0)
    want_key[2] = 1 + 2 * ROLL["steps"]
    assert torch.equal(ranks[0]["key"], want_key)


# ---------------------------------------------------------------- PPO helpers

@pytest.mark.parametrize("sizes", [(5, 9, 2), (0, 7, 7, 1), (12,)])
def test_moment_merge_equals_one_batch_moments(sizes):
    """Chan's rank-order merge of per-rank (count, mean, var) against the
    moments of the whole batch, empty ranks skipped; one rank is the
    identity."""
    rng = np.random.default_rng(sum(sizes))
    x = torch.from_numpy((3.0 + 2.0 * rng.normal(size=(sum(sizes), 4))).astype(np.float32))
    parts = torch.split(x, list(sizes))
    means = [p.mean(0) if len(p) else torch.zeros(4) for p in parts]
    variances = [p.var(0, correction=0) if len(p) else torch.zeros(4) for p in parts]
    n, mean, var = dp.merge_mean_var(list(sizes), means, variances)
    assert n == sum(sizes)
    np.testing.assert_allclose(mean.numpy(), x.mean(0).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), x.var(0, correction=0).numpy(), rtol=1e-5)
    if len([s for s in sizes if s]) == 1:
        i = next(i for i, s in enumerate(sizes) if s)
        assert mean is means[i] and var is variances[i]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_minibatch_members_split_the_global_minibatches(world):
    """Every global minibatch's members, split by owner rank and mapped
    back from local indices, are the minibatch itself (in permutation
    order per rank), with every rank's count; at one rank the permutation
    unchanged."""
    n_t, n_g, n_mb = 6, 8, 4
    gen = torch.Generator().manual_seed(1)
    perms = [torch.randperm(n_t * n_g, generator=gen) for _ in range(2)]
    b_l = n_g // world
    mb = n_t * n_g // n_mb
    per_rank = [dp.minibatch_members(perms, n_mb, n_t * n_g, n_g, fake_mesh(r, world)) for r in range(world)]
    for e in range(2):
        for k in range(n_mb):
            members = perms[e][k * mb:(k + 1) * mb]
            counts = per_rank[0][1][e][k]
            assert sum(counts) == mb and all(pr[1][e][k] == counts for pr in per_rank)
            back = []
            for r, (local, _) in enumerate(per_rank):
                idx = local[e, k, :counts[r]]
                glob = (idx // b_l) * n_g + r * b_l + idx % b_l
                assert torch.equal(glob, members[(members % n_g) // b_l == r])
                back.append(glob)
            assert sorted(torch.cat(back).tolist()) == sorted(members.tolist())
            if world == 1:
                assert torch.equal(per_rank[0][0][e, k], members)
