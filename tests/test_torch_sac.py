"""The port's SAC (``rsoccer_tpu_torch/models/sac.py``) held against the
JAX package's on the CPU: the actor and the stacked twin critics at f32
and bf16, ``sample_squashed``, the replay ring's inserts and n-step walk,
one update at the StaticDefenders recipe's settings, five train steps on
the unfused and the fused (plain) path through a truncation and a goal,
the actor freeze, the shipped SAC actors and a full-state round trip,
each fed the JAX package's draws.  SSLStaticDefenders-v0, B = 16, towers
(32, 32), small rings."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu.batch.vecenv import BatchedEnv as JaxBatchedEnv
from rsoccer_tpu.envs.base import draw_noise as jax_draw_noise
from rsoccer_tpu.models import sac as jsac
from rsoccer_tpu.utils import checkpoint as jax_checkpoint
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.envs.ssl_static_defenders import SDState
from rsoccer_tpu_torch.models import sac as tsac
from rsoccer_tpu_torch.ops.ssl_full import pack_sd_state
from rsoccer_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

ENV_ID = "SSLStaticDefenders-v0"
B = 16
HIDDEN = (32, 32)
OBS, ACT = 24, 5
ENV_ATOL = 2e-4  # the env's tolerance against the reference (tests/test_native_oracle.py)
PARAM_ATOL = 1e-5
BF16_ATOL = 1e-3  # the PPO networks' bf16 tolerance (tests/test_torch_ppo.py)
SHIPPED_ATOL = 1e-5  # the PPO networks' f32 tolerance, for the trained 256-wide actors
# the StaticDefenders recipe (artifacts/README.md, "SD best"), f32 towers
RECIPE = dict(batch_size=512, grad_steps_per_iter=2, n_step=8, gamma=0.995, reward_scale=10.0,
              target_entropy_scale=0.5, warmup_steps=50)
# five train steps: warmup for two, the actor frozen for two, a ring that wraps
TRAIN = dict(buffer_size=64, batch_size=32, warmup_steps=2, n_step=3, grad_steps_per_iter=2,
             actor_freeze_iters=2, gamma=0.995, reward_scale=10.0, target_entropy_scale=0.5)
N_TRAIN = 5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t_(a):
    return torch.from_numpy(np.array(a))


def jax_trainer(cfg_kwargs, max_steps=None, compute_dtype=jnp.float32):
    """A JAX SACTrainer on SD at B envs with (32, 32) towers."""
    jenv = rsoccer_tpu.make(ENV_ID)
    if max_steps is not None:
        jenv.max_episode_steps = max_steps
    jtr = jsac.SACTrainer(JaxBatchedEnv(jenv, B), jsac.SACConfig(**cfg_kwargs))
    jtr.actor = jsac.SquashedGaussianActor(action_size=ACT, hidden=HIDDEN, compute_dtype=compute_dtype)
    jtr.q = jsac.QCritic(hidden=HIDDEN, compute_dtype=compute_dtype)
    return jtr


def port_trainer(cfg_kwargs, max_steps=None, fused=False, dtype=torch.float32):
    tenv = rsoccer_tpu_torch.make(ENV_ID)
    if max_steps is not None:
        tenv.max_episode_steps = max_steps
    return tsac.SACTrainer(BatchedEnv(tenv, B, device="cpu", fused=fused),
                           tsac.SACConfig(**cfg_kwargs, hidden=HIDDEN, compute_dtype=dtype))


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def to_actor(params, dtype=torch.float32):
    return convert.sac_actor_from_leaves(leaves(params), device="cpu", compute_dtype=dtype)


def to_critics(params, dtype=torch.float32):
    return convert.sac_critics_from_leaves(leaves(params), OBS, device="cpu", compute_dtype=dtype)


def perturbed(params, seed, scale=0.1):
    """Every leaf plus seeded noise, so that biases are not the init's zeros."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + scale * rng.normal(size=x.shape).astype(np.float32)), params)


def assert_trees_close(got, want, atol, tag=""):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(paths)
    for (path, w), g in zip(paths, got_leaves):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=atol,
                                   err_msg=f"{tag}{jax.tree_util.keystr(path)}")


def port_state(ttr, jstate, fused=False):
    """The port's SACState equal to a JAX SACState with fresh Adam states
    (every test starts from one)."""
    actor = to_actor(jstate.actor_params, ttr.cfg.compute_dtype)
    qs = to_critics(jstate.qs_params, ttr.cfg.compute_dtype)
    qs_target = to_critics(jstate.qs_target, ttr.cfg.compute_dtype)
    log_alpha = t_(jstate.log_alpha).requires_grad_(True)
    buf = tsac.Buffer(ttr.cfg.buffer_size, OBS, ACT, "cpu")
    jb = jstate.buffer
    for name in ("obs", "action", "rdb", "next_obs"):
        getattr(buf, name).copy_(t_(getattr(jb, name)))
    buf.ptr, buf.filled = int(jb.ptr), int(jb.filled)
    buf.width = B if buf.filled else None
    env_state = convert.state_from_numpy(np_tree(jstate.env_state), SDState, device="cpu")
    if fused:
        env_state = pack_sd_state(env_state)
    return tsac.SACState(
        actor=actor, qs=qs, qs_target=qs_target, log_alpha=log_alpha,
        opt_actor=ttr.make_optimizer(actor.parameters()), opt_qs=ttr.make_optimizer(qs.parameters()),
        opt_alpha=ttr.make_optimizer([log_alpha]), buffer=buf, env_state=env_state,
        obs=t_(jstate.obs), env_key=torch.tensor([1, 2, 0]), total_steps=int(jstate.total_steps),
        iteration=int(jstate.total_steps),
    )


def port_moments(state, which):
    """Adam's first moment of the actor (or the critics) as the JAX params tree."""
    mod = copy.deepcopy(state.actor if which == "actor" else state.qs)
    opt = state.opt_actor if which == "actor" else state.opt_qs
    for p, q in zip(mod.parameters(), (state.actor if which == "actor" else state.qs).parameters()):
        p.data = opt.state[q]["exp_avg"].clone()
    return convert.sac_actor_to_numpy(mod) if which == "actor" else convert.sac_critics_to_numpy(mod)


def jax_update_draws(jtr, filled, key):
    """What the JAX ``_update(state, key)`` draws, at a ring of ``filled``."""
    cfg = jtr.cfg
    k_s, k_next, k_pi = jax.random.split(key, 3)
    valid = max(filled - (cfg.n_step - 1) * B, 1)
    shape = (cfg.batch_size, ACT)
    return tsac.UpdateDraws(
        offsets=t_(jax.random.randint(k_s, (cfg.batch_size,), 0, valid)).long(),
        next_eps=t_(jax.random.normal(k_next, shape)),
        pi_eps=t_(jax.random.normal(k_pi, shape)),
    )


def jax_train_draws(jtr, state, key):
    """What the JAX ``train_step(state, key)`` draws: per collect the
    policy's normals, the warmup's uniforms and the env noise; per update
    the offsets and both normals."""
    cfg, benv = jtr.cfg, jtr.benv
    collects, updates = [], []
    for _ in range(cfg.env_steps_per_iter):
        key, k = jax.random.split(key)
        k_act, k_env = jax.random.split(k)
        kt, kr = jax.random.split(k_env)
        env = tuple(convert.noise_from_numpy(np_tree(jax_draw_noise(kk, spec, batch=B)), device="cpu")
                    for kk, spec in ((kt, benv._t_spec), (kr, benv._r_spec)))
        collects.append(tsac.CollectDraws(
            normal=t_(jax.random.normal(k_act, (B, ACT))),
            uniform=t_(jax.random.uniform(k_act, (B, ACT), minval=-1.0, maxval=1.0)), env=env))
    filled = min(int(state.buffer.filled) + cfg.env_steps_per_iter * B, cfg.buffer_size)
    for _ in range(cfg.grad_steps_per_iter):
        key, k = jax.random.split(key)
        updates.append(jax_update_draws(jtr, filled, k))
    return collects, updates


def feed(monkeypatch, ttr, collects, updates):
    """Make the port's train_step draw ``collects`` and ``updates`` in order."""
    c_it, u_it = iter(collects), iter(updates)
    monkeypatch.setattr(ttr, "collect_draws", lambda state, gen: next(c_it))
    monkeypatch.setattr(ttr, "update_draws", lambda state, gen: next(u_it))


# ---------------------------------------------------------------- networks

@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6), ("bfloat16", BF16_ATOL)])
def test_actor_and_critics_forward_match_flax(dtype, atol):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jactor = jsac.SquashedGaussianActor(action_size=ACT, hidden=HIDDEN, compute_dtype=jdt)
    jq = jsac.QCritic(hidden=HIDDEN, compute_dtype=jdt)
    o, a = jnp.zeros((1, OBS)), jnp.zeros((1, ACT))
    ap = perturbed(jactor.init(jax.random.PRNGKey(0), o), 1)
    qp = perturbed(jax.tree.map(lambda x, y: jnp.stack([x, y]), jq.init(jax.random.PRNGKey(1), o, a),
                                jq.init(jax.random.PRNGKey(2), o, a)), 2)
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(256, OBS)).astype(np.float32)
    act = rng.uniform(-1, 1, size=(256, ACT)).astype(np.float32)
    j_mean, j_log_std = jactor.apply(ap, jnp.asarray(obs))
    j_q = jax.vmap(jq.apply, in_axes=(0, None, None))(qp, jnp.asarray(obs), jnp.asarray(act))
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        mean, log_std = to_actor(ap, tdt)(t_(obs))
        q = to_critics(qp, tdt)(t_(obs), t_(act))
    assert mean.dtype == log_std.dtype == q.dtype == torch.float32 and q.shape == (2, 256)
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=0, atol=atol)
    np.testing.assert_allclose(log_std.numpy(), np.asarray(j_log_std), rtol=0, atol=atol)
    np.testing.assert_allclose(q.numpy(), np.asarray(j_q), rtol=0, atol=atol)
    assert float(log_std.min()) >= -5.0 and float(log_std.max()) <= 2.0


@pytest.mark.parametrize("spread", [0.7, 2.5], ids=["typical", "saturated"])
def test_sample_squashed_matches(spread):
    """The action within 1e-6, the log-prob within 1e-6 plus what the tanh
    correction makes of the two tanh's: XLA's CPU tanh is a rational
    approximation (up to 2.6e-7 off, and exactly +-1 from |z| ~ 7.9) where
    torch's is within 3.2e-8, and log(1 - a^2 + 1e-6) scales a difference
    in ``a`` by 2|a| / (1 - a^2 + 1e-6).  The "saturated" case reaches
    |z| ~ 10, where that term alone differs by up to 0.4."""
    rng = np.random.default_rng(4)
    mean = (spread * rng.normal(size=(256, ACT))).astype(np.float32)
    log_std = rng.uniform(-3.0, 0.5, size=(256, ACT)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    j_a, j_logp = jsac.sample_squashed(key, jnp.asarray(mean), jnp.asarray(log_std))
    eps = t_(jax.random.normal(key, mean.shape))
    a, logp = tsac.sample_squashed(t_(mean), t_(log_std), eps)
    np.testing.assert_allclose(a.numpy(), np.asarray(j_a), rtol=0, atol=1e-6)
    a64 = np.abs(a.numpy().astype(np.float64))
    tanh_err = 2.6e-7 + 3.2e-8
    bound = 1e-6 + np.sum(2 * a64 * tanh_err / (1 - a64**2 + 1e-6), axis=-1)
    assert np.all(np.abs(logp.numpy() - np.asarray(j_logp)) <= bound)
    typical = np.all(a64 < 0.76, axis=-1)  # |z| < 1 in every dimension
    np.testing.assert_allclose(logp.numpy()[typical], np.asarray(j_logp)[typical], rtol=0, atol=1e-6 * ACT)


def test_init_statistics_match_flax():
    """lecun-normal kernels (a normal cut at +-2 sigma, std sqrt(1/fan_in)),
    zero biases, drawn from the seed: the port's against flax's, by
    statistics (the streams differ)."""
    def gen():
        return torch.Generator().manual_seed(3)

    a = tsac.SquashedGaussianActor(OBS, ACT, (256, 256), device="cpu", gen=gen())
    assert all(torch.equal(p, q) for p, q in zip(
        a.parameters(), tsac.SquashedGaussianActor(OBS, ACT, (256, 256), device="cpu", gen=gen()).parameters()))
    q = tsac.TwinQCritic(OBS, ACT, (256, 256), device="cpu", gen=gen())
    jp = jsac.SquashedGaussianActor(action_size=ACT).init(jax.random.PRNGKey(3), jnp.zeros((1, OBS)))
    jw = np.asarray(jp["params"]["fc1"]["kernel"])
    for w, fan_in in ((a.tower[1].weight.detach().numpy(), 256), (q.kernels[1][1].detach().numpy(), 256),
                      (q.kernels[0][0].detach().numpy(), OBS + ACT), (jw, 256)):
        std = np.sqrt(1.0 / fan_in)
        assert abs(w.std() / std - 1.0) < 0.03
        assert abs(w.mean()) < 0.03 * std
        assert np.abs(w).max() <= 2.0 * std / 0.87962566 * (1 + 1e-6)
        # the share beyond one sigma of the cut normal, as flax's
        assert abs((np.abs(w) > std).mean() - (np.abs(jw) > np.sqrt(1 / 256)).mean()) < 0.01
    assert not any(b.detach().any() for b in (*q.biases, a.mean.bias, a.log_std.bias, a.tower[0].bias))
    assert not torch.equal(q.kernels[1][0], q.kernels[1][1])  # two critics, two draws


def test_adam_matches_optax_over_many_steps():
    """The trainer's Adam (torch's, eps 1e-8) against optax.adam(lr) over 30
    steps of f32 gradients spread over eight decades, on a stacked
    (2, 29, 32) kernel and a scalar (log_alpha's shape): torch computes the
    bias corrections in another order, and stays within 1e-6."""
    import optax

    rng = np.random.default_rng(11)
    shapes = [(2, OBS + ACT, 32), ()]
    p0 = [np.asarray(rng.normal(size=sh), dtype=np.float32) for sh in shapes]
    grads = [[np.asarray(rng.normal(size=sh) * 10.0 ** rng.integers(-6, 2, size=sh), dtype=np.float32) for sh in shapes]
             for _ in range(30)]
    tx = optax.adam(3e-4)
    params = [jnp.asarray(x) for x in p0]
    opt_state = tx.init(params)
    tp = [torch.tensor(x, requires_grad=True) for x in p0]
    opt = port_trainer(dict(buffer_size=64)).make_optimizer(tp)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state)
        params = optax.apply_updates(params, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(np.asarray(x))
        opt.step()
        for p, q in zip(tp, params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=0, atol=1e-6)
    assert float(np.abs(tp[0].detach().numpy() - p0[0]).max()) > 1e-3  # the params moved


# ---------------------------------------------------------------- the ring

@pytest.mark.parametrize("capacity", [8, 10], ids=["contiguous", "scatter"])
def test_add_batch_matches_and_wraps(capacity):
    """Width 4 into capacity 8 (slice copies) and 10 (the modular scatter),
    through two wraps: the rings equal the JAX package's."""
    rng = np.random.default_rng(capacity)
    jb = jsac.Buffer.init(capacity, 3, 2)
    tb = tsac.Buffer(capacity, 3, 2, "cpu")
    for _ in range(6):
        o, no = rng.normal(size=(2, 4, 3)).astype(np.float32)
        a = rng.normal(size=(4, 2)).astype(np.float32)
        r, d, bd = rng.normal(size=(3, 4)).astype(np.float32)
        jb = jb.add_batch(*map(jnp.asarray, (o, a, r, no, d, bd)))
        tb.add_batch(*map(t_, (o, a, r, no, d, bd)))
        assert (tb.ptr, tb.filled) == (int(jb.ptr), int(jb.filled))
        for name in ("obs", "action", "rdb", "next_obs"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    assert tb.filled == capacity and tb.width == 4
    idx = np.array([0, 3, 7])
    want = (jb.obs[idx], jb.action[idx], jb.reward[idx], jb.next_obs[idx], jb.done[idx])
    for got, w in zip(tb.sample(torch.from_numpy(idx)), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


@pytest.mark.parametrize("capacity", [8, 10], ids=["contiguous", "scatter"])
def test_add_batch_refuses_a_changed_width(capacity):
    """The port's ring refuses any width other than its first, on both
    paths.  The JAX ring's contiguous insert takes it and clamps at the
    ring's end: 8 rows at ptr 4 of 8 slots land at [0, 8), so slot 4 holds
    row 4 where a wrapping ring holds row 0."""
    def rows(w, v):
        o = (v + np.arange(w, dtype=np.float32))[:, None]
        z = np.zeros(w, np.float32)
        return o, np.zeros((w, 1), np.float32), z, o, z, z

    if capacity == 8:
        jb = jsac.Buffer.init(8, 1, 1).add_batch(*map(jnp.asarray, rows(4, 0.0)))
        jb = jb.add_batch(*map(jnp.asarray, rows(8, 10.0)))
        assert float(jb.obs[4, 0]) == 14.0 and int(jb.ptr) == 4
    tb = tsac.Buffer(capacity, 1, 1, "cpu")
    tb.add_batch(*map(t_, rows(4, 0.0)))
    for w in (2, 8):
        with pytest.raises(ValueError, match=f"insert width {w} differs"):
            tb.add_batch(*map(t_, rows(w, 10.0)))
    assert (tb.ptr, tb.filled, tb.width) == (4, 4, 4)
    tb.add_batch(*map(t_, rows(4, 20.0)))  # the ring's own width still goes in
    assert (tb.ptr, tb.filled) == (8 % capacity, 8)


def _chain_ring(n_inserts, capacity, seed):
    """Both rings after ``n_inserts`` inserts of width B: obs holds the
    insert's index and the env (so a gathered row names its slot), rewards,
    dones and boundaries random."""
    rng = np.random.default_rng(seed)
    jb = jsac.Buffer.init(capacity, 2, 1)
    tb = tsac.Buffer(capacity, 2, 1, "cpu")
    for t in range(n_inserts):
        o = np.stack([np.full(B, t), np.arange(B)], -1).astype(np.float32)
        r = rng.normal(size=B).astype(np.float32)
        d = (rng.random(B) < 0.05).astype(np.float32)
        bd = np.maximum(d, (rng.random(B) < 0.05).astype(np.float32))
        a = np.zeros((B, 1), np.float32)
        jb = jb.add_batch(*map(jnp.asarray, (o, a, r, o + 1000.0, d, bd)))
        tb.add_batch(*map(t_, (o, a, r, o + 1000.0, d, bd)))
    return jb, tb


@pytest.mark.parametrize("n_step", [1, 8])
@pytest.mark.parametrize("n_inserts", [1, 3, 8, 13], ids=["first", "early", "full", "wrapped"])
def test_sample_nstep_matches(n_step, n_inserts):
    """The chain walk at n 1 and 8 with the ring after one insert, early in
    the filling (chains longer than what is written), full, and wrapped
    (8 inserts of width B into 8 B slots, then 5 more): the gathered slots
    exactly, G and boot_disc within 1e-6."""
    capacity, batch, gamma = 8 * B, 256, 0.995
    jb, tb = _chain_ring(n_inserts, capacity, seed=10 * n_step + n_inserts)
    key = jax.random.PRNGKey(n_step * 100 + n_inserts)
    j_o, _, j_g, j_boot, j_disc = jb.sample_nstep(key, batch, stride=B, n_step=n_step, gamma=gamma)
    valid = tb.nstep_window(B, n_step)
    assert valid == max(int(jb.filled) - (n_step - 1) * B, 1)
    off = t_(jax.random.randint(key, (batch,), 0, valid)).long()
    o, _, g, boot, disc = tb.sample_nstep(off, B, n_step, gamma)
    np.testing.assert_array_equal(o.numpy(), np.asarray(j_o))
    np.testing.assert_array_equal(boot.numpy(), np.asarray(j_boot))
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=0, atol=1e-6)
    np.testing.assert_allclose(disc.numpy(), np.asarray(j_disc), rtol=0, atol=1e-6)
    chain_len = np.asarray(j_boot)[:, 0] - 1000.0 - np.asarray(j_o)[:, 0]  # links - 1
    if n_step == 8 and n_inserts >= 8:
        assert chain_len.max() == 7 and (chain_len < 7).any()  # full chains, and cut ones
    if n_step == 8 and n_inserts == 3:
        assert chain_len.max() <= 2  # the unwritten links cut every chain


# ---------------------------------------------------------------- one update

def test_update_matches_at_the_recipe():
    """One update at the SD recipe's settings (batch 512, n 8, gamma 0.995,
    reward scale 10, target entropy 0.5 x A) on a ring of random
    transitions: the losses, the gradients (Adam's first moments after its
    first step), the new actor, critics, target critics and log_alpha, and
    the metrics within 1e-5."""
    cfg = dict(RECIPE, buffer_size=16 * B)
    jtr, ttr = jax_trainer(cfg), port_trainer(cfg)
    js = jtr.init(jax.random.PRNGKey(0))
    js = js._replace(actor_params=perturbed(js.actor_params, 6, scale=0.02))
    rng = np.random.default_rng(7)
    buf = js.buffer
    for _ in range(12):  # 12 of 16 inserts
        o, no = (0.5 * rng.normal(size=(2, B, OBS))).astype(np.float32)
        d = (rng.random(B) < 0.1).astype(np.float32)
        buf = buf.add_batch(jnp.asarray(o), jnp.asarray(rng.uniform(-1, 1, (B, ACT)).astype(np.float32)),
                            jnp.asarray(0.1 * rng.normal(size=B).astype(np.float32)), jnp.asarray(no),
                            jnp.asarray(d), jnp.asarray(np.maximum(d, rng.random(B) < 0.05).astype(np.float32)))
    js = js._replace(buffer=buf, total_steps=jnp.asarray(60, jnp.int32))
    key = jax.random.PRNGKey(8)
    j_new, j_m = jax.jit(jtr._update)(js, key)
    ts = port_state(ttr, js)
    ts, t_m = ttr._update(ts, jax_update_draws(jtr, int(buf.filled), key))
    for k in j_m:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=0, atol=PARAM_ATOL, err_msg=k)
    scale = 1.0 / (1.0 - 0.9)  # Adam's first moment after one step is 0.1 x the gradient
    for which, opt in (("qs", j_new.opt_qs), ("actor", j_new.opt_actor)):
        assert_trees_close(jax.tree.map(lambda x: x * scale, port_moments(ts, which)),
                           jax.tree.map(lambda x: np.asarray(x) * scale, opt[0].mu), PARAM_ATOL,
                           f"{which} grad ")
    np.testing.assert_allclose(float(ts.opt_alpha.state[ts.log_alpha]["exp_avg"]) * scale,
                               float(j_new.opt_alpha[0].mu) * scale, rtol=0, atol=PARAM_ATOL)
    assert_trees_close(convert.sac_actor_to_numpy(ts.actor), np_tree(j_new.actor_params), PARAM_ATOL, "actor ")
    assert_trees_close(convert.sac_critics_to_numpy(ts.qs), np_tree(j_new.qs_params), PARAM_ATOL, "qs ")
    assert_trees_close(convert.sac_critics_to_numpy(ts.qs_target), np_tree(j_new.qs_target), PARAM_ATOL,
                       "qs_target ")
    np.testing.assert_allclose(float(ts.log_alpha.detach()), float(j_new.log_alpha), rtol=0, atol=PARAM_ATOL)
    assert float(ts.log_alpha.detach()) != float(js.log_alpha)  # the temperature moved


# ---------------------------------------------------------------- train steps

@pytest.fixture(scope="module")
def jax_run():
    """Five JAX train steps of the TRAIN config with max steps 3, from an
    init whose env 0 kicks the ball into the goal on the first step: the
    states before each step, each step's draws and metrics."""
    jtr = jax_trainer(TRAIN, max_steps=3)
    s = jtr.init(jax.random.PRNGKey(0))
    ball = s.env_state.world.ball
    ball = ball._replace(x=ball.x.at[0].set(jtr.benv.env.field.half_length - 0.02),
                         y=ball.y.at[0].set(0.0), v_x=ball.v_x.at[0].set(3.0), v_y=ball.v_y.at[0].set(0.0))
    env_state = s.env_state._replace(world=s.env_state.world._replace(ball=ball))
    s = s._replace(env_state=env_state,
                   obs=jax.vmap(jtr.benv.env.observe, in_axes=-1, out_axes=-1)(env_state))
    step = jax.jit(jtr.train_step)
    states, draws, metrics = [s], [], []
    for i in range(N_TRAIN):
        key = jax.random.PRNGKey(100 + i)
        draws.append(jax_train_draws(jtr, states[-1], key))
        s, m = step(states[-1], key)
        states.append(s)
        metrics.append(np_tree(m))
    return jtr, states, draws, metrics


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_train_steps_match_through_truncation_and_goal(monkeypatch, jax_run, fused):
    """Five port train steps (two of warmup, the actor frozen for two) fed
    the JAX run's draws, on the unfused env and the fused step's plain
    version: every step's params, log_alpha and metrics within 1e-5, the
    env state and obs within 2e-4, the ring's flags exactly."""
    jtr, states, draws, metrics = jax_run
    ttr = port_trainer(TRAIN, max_steps=3, fused=fused)
    ts = port_state(ttr, states[0], fused=fused)
    actor0 = convert.sac_actor_to_numpy(ts.actor)
    for i in range(N_TRAIN):
        feed(monkeypatch, ttr, *draws[i])
        ts, m = ttr.train_step(ts, None)
        js = np_tree(states[i + 1])
        tag = f"step {i} "
        assert_trees_close(convert.sac_actor_to_numpy(ts.actor), js.actor_params, PARAM_ATOL, tag + "actor ")
        assert_trees_close(convert.sac_critics_to_numpy(ts.qs), js.qs_params, PARAM_ATOL, tag + "qs ")
        assert_trees_close(convert.sac_critics_to_numpy(ts.qs_target), js.qs_target, PARAM_ATOL, tag + "target ")
        np.testing.assert_allclose(float(ts.log_alpha.detach()), js.log_alpha, rtol=0, atol=PARAM_ATOL)
        for k, v in metrics[i].items():  # q_loss reaches ~2.5e3 after the goal: one f32 ulp is 2.4e-4
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-6, atol=PARAM_ATOL, err_msg=tag + k)
        want = convert.state_from_numpy(js.env_state, SDState, device="cpu")
        if fused:
            np.testing.assert_allclose(ts.env_state.numpy(), pack_sd_state(want).numpy(), rtol=0,
                                       atol=ENV_ATOL, err_msg=tag + "env")
        else:
            for got, w in zip(jax.tree.leaves(convert.state_to_numpy(ts.env_state)),
                              jax.tree.leaves(convert.state_to_numpy(want))):
                np.testing.assert_allclose(got.astype(np.float64), w.astype(np.float64), rtol=0,
                                           atol=ENV_ATOL, err_msg=tag + "env")
        np.testing.assert_allclose(ts.obs.numpy(), js.obs, rtol=0, atol=ENV_ATOL)
        assert (ts.buffer.ptr, ts.buffer.filled) == (int(js.buffer.ptr), int(js.buffer.filled))
        np.testing.assert_array_equal(ts.buffer.rdb[:, 1:].numpy(), js.buffer.rdb[:, 1:])
        np.testing.assert_allclose(ts.buffer.next_obs.numpy(), js.buffer.next_obs, rtol=0, atol=ENV_ATOL)
        if i == 1:  # frozen through iterations 0 and 1 (JAX: total_steps <= 2)
            assert_trees_close(convert.sac_actor_to_numpy(ts.actor), actor0, 0.0, "frozen ")
            assert float(ts.log_alpha.detach()) == float(states[0].log_alpha)
            assert not ts.opt_actor.state  # a frozen actor's Adam never stepped
    assert float(states[1].buffer.rdb[0, 0]) == 5.0, "expected env 0's goal (+5) on the first step"
    rdb = states[-1].buffer.rdb
    assert float(jnp.sum(rdb[:, 2] * (1 - rdb[:, 1]))) >= B, "expected truncations in the ring"
    assert int(states[-1].buffer.filled) == TRAIN["buffer_size"]  # wrapped
    assert ts.iteration == ts.total_steps == N_TRAIN


def test_actor_freeze_counts_iterations():
    """At env_steps_per_iter 2 the port holds the actor and temperature for
    actor_freeze_iters ITERATIONS (their Adam never steps), then moves them;
    the JAX package counts collect calls and releases after half as many."""
    cfg = dict(TRAIN, env_steps_per_iter=2, actor_freeze_iters=2, buffer_size=128)
    ttr = port_trainer(cfg)
    ts = ttr.init(0)
    a0 = [p.detach().clone() for p in ts.actor.parameters()]
    la0 = float(ts.log_alpha.detach())
    for i in range(2):
        assert ttr.actor_frozen(ts)
        ts, _ = ttr.train_step(ts, tsac.iteration_generator(0, i, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(a0, ts.actor.parameters()))
    assert float(ts.log_alpha.detach()) == la0 and not ts.opt_actor.state and not ts.opt_alpha.state
    assert ts.total_steps == 4 and len(ts.opt_qs.state) > 0
    ts, _ = ttr.train_step(ts, tsac.iteration_generator(0, 2, "cpu"))
    assert not ttr.actor_frozen(ts)
    assert all(not torch.equal(a, b) for a, b in zip(a0, ts.actor.parameters()))
    assert float(ts.log_alpha.detach()) != la0
    # the JAX package's freeze at the same setting: iteration 1 sees
    # total_steps 4 > 2, and its actor moves there
    frozen_jax = [(i + 1) * cfg["env_steps_per_iter"] <= cfg["actor_freeze_iters"] for i in range(3)]
    assert frozen_jax == [True, False, False]


def test_buffer_size_check():
    for make in (lambda c: jax_trainer(c), lambda c: port_trainer(c)):
        with pytest.raises(ValueError, match="n_step \\* n_envs"):
            make(dict(buffer_size=7 * B, n_step=8))
        make(dict(buffer_size=8 * B, n_step=8))


def test_train_step_runs_on_the_fused_path():
    """The port's own draws (a generator per iteration) on the fused
    path's plain version: finite metrics, every parameter moved after
    warmup, the target critics moved toward the critics."""
    ttr = tsac.SACTrainer(rsoccer_tpu_torch.make_vec(ENV_ID, B, device="cpu", fused=True, fused_rng="kernel"),
                          tsac.SACConfig(buffer_size=64, batch_size=32, warmup_steps=1, hidden=HIDDEN))
    ts = ttr.init(0)
    p0 = [p.detach().clone() for p in (*ts.actor.parameters(), *ts.qs_target.parameters())]
    for i in range(2):
        ts, m = ttr.train_step(ts, tsac.iteration_generator(0, i, "cpu"))
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert all(not torch.equal(a, b) for a, b in zip(p0, (*ts.actor.parameters(), *ts.qs_target.parameters())))
    assert int(ts.env_key[2]) == 1 + 2 and ts.buffer.filled == 2 * B
    ms = ttr.phase_ms()
    assert ms["collect_ms"] > 0 and ms["update_ms"] > 0


# ---------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("name,env_id", [("sac_sd_best2", ENV_ID), ("sac_cp_nstep", "SSLContestedPossession-v0"),
                                         ("sd_sac_bc", ENV_ID)])
def test_shipped_actor_loads_and_acts_as_flax(name, env_id):
    """A shipped SAC actor through load_sac_checkpoint (no jax): its leaves
    bit for bit, and flax's deterministic actions and a sample from the
    same normals within SHIPPED_ATOL.  Not 1e-6: the trained 256-wide
    layers carry activations up to ~50, where f32 sums in another order
    part by ~6e-6 in the mean (flax's and the port's each lie ~2e-5 from
    the f64 evaluation); so the port is also held to be no farther from
    the f64 evaluation than flax is, within one part in 1e6 of the
    activations' scale."""
    path = f"artifacts/{name}.ckpt.npz"
    obs_size = rsoccer_tpu_torch.make(env_id).obs_size
    jactor = jsac.SquashedGaussianActor(action_size=ACT)
    like = jactor.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_size)))
    params = jax.tree.map(jnp.asarray, jax_checkpoint.restore(path, like=like))
    actor = convert.load_sac_checkpoint(path, device="cpu")
    assert actor.hidden == (256, 256) and actor.obs_size == obs_size
    for got_leaf, want in zip(checkpoint.flatten(convert.sac_actor_to_numpy(actor)), checkpoint.load_leaves(path)):
        np.testing.assert_array_equal(got_leaf, want)
    obs = np.random.default_rng(9).uniform(-1, 1, size=(obs_size, 64)).astype(np.float32)
    j_mean, j_log_std = jactor.apply(params, jnp.asarray(obs.T))
    got = tsac.make_policy(actor)(None, t_(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.tanh(j_mean)).T, rtol=0, atol=SHIPPED_ATOL)
    key = jax.random.PRNGKey(10)
    j_a, _ = jsac.sample_squashed(key, j_mean, j_log_std)
    with torch.no_grad():
        mean, log_std = actor(t_(obs.T))
        a, _ = tsac.sample_squashed(mean, log_std, t_(jax.random.normal(key, j_mean.shape)))
        x = t_(obs.T).double()
        for layer in actor.tower:
            x = torch.relu(torch.nn.functional.linear(x, layer.weight.double(), layer.bias.double()))
        mean64 = torch.nn.functional.linear(x, actor.mean.weight.double(), actor.mean.bias.double())
    np.testing.assert_allclose(a.numpy(), np.asarray(j_a), rtol=0, atol=SHIPPED_ATOL)
    err_port = np.abs(mean.numpy() - mean64.numpy()).max()
    err_flax = np.abs(np.asarray(j_mean) - mean64.numpy()).max()
    assert err_port <= 2.0 * err_flax + 1e-6, (err_port, err_flax)


def test_actor_leaf_mismatch_names_the_leaf():
    good = checkpoint.load_leaves("artifacts/sac_sd_best2.ckpt.npz")
    bad = list(good)
    bad[5] = bad[5][:, :4]  # log_std kernel with 4 outputs
    with pytest.raises(ValueError, match="leaf_5 \\(log_std.kernel\\)"):
        convert.sac_actor_from_leaves(bad, device="cpu")
    with pytest.raises(ValueError, match="4 \\+ 2 x"):
        convert.sac_actor_from_leaves(good[:7], device="cpu")
    bad = list(good)
    bad[0] = bad[0].astype(np.float64)
    with pytest.raises(ValueError, match="leaf_0 \\(fc0.bias\\)"):
        convert.sac_actor_from_leaves(bad, device="cpu")


def test_full_state_round_trip_is_bit_exact(tmp_path):
    """state_tree -> save -> restore -> state_from_tree gives every tensor
    back bit for bit (ring and Adam included), and one more train step
    from each, with the same generator seed, equal bit for bit."""
    ttr = tsac.SACTrainer(rsoccer_tpu_torch.make_vec(ENV_ID, B, device="cpu", fused=True, fused_rng="kernel"),
                          tsac.SACConfig(buffer_size=48, batch_size=32, warmup_steps=1, n_step=2,
                                         hidden=HIDDEN, actor_freeze_iters=1))
    ts = ttr.init(1)
    for i in range(4):  # 4 x 16 into 48 slots: wrapped
        ts, _ = ttr.train_step(ts, tsac.iteration_generator(1, i, "cpu"))
    path = str(tmp_path / "sac_state.ckpt")
    checkpoint.save(path, ttr.state_tree(ts))
    back = ttr.state_from_tree(checkpoint.restore(path, like=ttr.state_tree(ts)))

    def flat(s):
        return [torch.as_tensor(x) for x in checkpoint.flatten(ttr.state_tree(s))]

    assert all(torch.equal(a, b) for a, b in zip(flat(ts), flat(back)))
    assert (back.buffer.ptr, back.buffer.filled, back.buffer.width) == (16, 48, B)
    s1, m1 = ttr.train_step(ts, tsac.iteration_generator(1, 4, "cpu"))
    s2, m2 = ttr.train_step(back, tsac.iteration_generator(1, 4, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(flat(s1), flat(s2)))
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


def test_train_script_resumes_as_uninterrupted_and_jax_reads_its_actor(tmp_path, capsys):
    """train_sac_vss: 4 iterations in one run, and 2 then 2 more through
    --state-save / --resume, end with the same actor bit for bit (iteration
    i draws from (seed + 1, i)); the JAX package restores the saved actor;
    eval_policy --algo sac scores it."""
    from rsoccer_tpu_torch.examples import eval_policy, train_sac_vss

    common = ["--device", "cpu", "--env-id", ENV_ID, "--fused", "--envs", "16", "--buffer-size", "128",
              "--batch-size", "32", "--n-step", "4", "--warmup", "1", "--seed", "3"]
    one, two = str(tmp_path / "one_{i}.ckpt"), str(tmp_path / "two_{i}.ckpt")
    train_sac_vss.main(common + ["--iters", "4", "--save", one])
    state = str(tmp_path / "state")
    train_sac_vss.main(common + ["--iters", "2", "--eval-every", "2", "--eval-envs", "8", "--state-save", state])
    train_sac_vss.main(common + ["--iters", "4", "--state-save", state, "--resume", "--save", two])
    assert "resumed the whole SAC state" in capsys.readouterr().out
    got = checkpoint.load_leaves(two.replace("{i}", "4"))
    want = checkpoint.load_leaves(one.replace("{i}", "4"))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    like = jsac.SquashedGaussianActor(action_size=ACT).init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    back = jax_checkpoint.restore(one.replace("{i}", "4"), like=like)
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(jax.tree.leaves(back), want))
    eval_policy.main(["--device", "cpu", "--env-id", ENV_ID, "--algo", "sac", "--params",
                      one.replace("{i}", "4") + ".npz", "--envs", "8", "--steps", "5", "--fused"])
    assert "8 envs x 5 steps" in capsys.readouterr().out


# ---------------------------------------------------------------- no fallback

def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsac.SACTrainer(BatchedEnv(rsoccer_tpu_torch.make(ENV_ID), B))
    for build in (lambda: tsac.SquashedGaussianActor(OBS, ACT), lambda: tsac.TwinQCritic(OBS, ACT),
                  lambda: tsac.Buffer(64, OBS, ACT),
                  lambda: convert.load_sac_checkpoint("artifacts/sac_sd_best2.ckpt.npz")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
