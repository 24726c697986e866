"""The port's PPO (``rsoccer_tpu_torch/models``) held against the JAX
package's on the CPU: the network at f32 and bf16, ObsNorm, GAE, the loss
and its gradients, the whole update phase (both minibatch modes, anneal,
critic warmup), and ``_rollout`` through truncations on the unfused and
fused paths, each fed the JAX package's draws.  VSS-v0, B = 16, T = 8,
towers (32, 32)."""

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
from rsoccer_tpu.models import networks as jnet
from rsoccer_tpu.models.ppo import ObsNorm as JaxObsNorm
from rsoccer_tpu.models.ppo import PPOConfig as JaxPPOConfig
from rsoccer_tpu.models.ppo import PPOTrainer as JaxPPOTrainer
from rsoccer_tpu.models.ppo import Transition as JaxTransition
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.envs.vss import VSSState
from rsoccer_tpu_torch.models import networks as tnet
from rsoccer_tpu_torch.models.ppo import ObsNorm, PPOConfig, PPOTrainer, Transition
from rsoccer_tpu_torch.ops.vss_full import pack_vss_state

torch.set_num_threads(1)

B, T = 16, 8
HIDDEN = (32, 32)
OBS, ACT = 40, 2
ENV_ATOL = 2e-4  # the env's tolerance against the reference (tests/test_native_oracle.py)
# bf16 towers after one update phase (4 epochs x 4 minibatches of Adam):
# each step moves a param by up to lr = 3e-4, so a bf16 rounding that turns
# a small gradient's sign shows at that size
BF16_UPDATE_ATOL = 2e-3


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t_(a):
    return torch.from_numpy(np.array(a))


def jax_params(seed=0, hidden=HIDDEN, perturb=True):
    """flax ActorCritic params; with ``perturb`` every leaf gets seeded
    noise, so biases and log_std are not the init's zeros."""
    net = jnet.ActorCritic(action_size=ACT, hidden=hidden)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)))
    if perturb:
        rng = np.random.default_rng(seed)
        params = jax.tree.map(
            lambda x: jnp.asarray(np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32)),
            params,
        )
    return params


def to_port(params, obs_norm=None, dtype=torch.float32):
    """JAX params (+ obs_norm) -> the port's (ActorCritic, ObsNorm) on the CPU."""
    obs_norm = JaxObsNorm.init(OBS) if obs_norm is None else obs_norm
    leaves = jax.tree.leaves({"params": params, "obs_norm": obs_norm})
    return convert.ppo_from_leaves([np.asarray(x) for x in leaves], device="cpu", compute_dtype=dtype)


def port_params(net):
    """The port's params as the JAX package's params tree (numpy)."""
    return convert.ppo_to_numpy(net, ObsNorm.init(net.obs_size, "cpu"))["params"]


def port_grads(net):
    g_net = copy.deepcopy(net)
    for p, q in zip(g_net.parameters(), net.parameters()):
        p.data = q.grad.clone()
    return port_params(g_net)


def assert_trees_close(got, want, atol, tag=""):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(paths)
    for (path, w), g in zip(paths, got_leaves):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=atol,
                                   err_msg=f"{tag}{jax.tree_util.keystr(path)}")


def trainers(cfg_kwargs=None, max_steps=None, fused=False):
    """(JAX trainer with an f32 net, the port's trainer) on VSS-v0, B envs."""
    kw = {"rollout_steps": T, "hidden": HIDDEN, **(cfg_kwargs or {})}
    jenv, tenv = rsoccer_tpu.make("VSS-v0"), rsoccer_tpu_torch.make("VSS-v0")
    if max_steps is not None:
        jenv.max_episode_steps = tenv.max_episode_steps = max_steps
    jtr = JaxPPOTrainer(JaxBatchedEnv(jenv, B), JaxPPOConfig(**kw))
    jtr.net = jnet.ActorCritic(action_size=ACT, hidden=HIDDEN, compute_dtype=jnp.float32)
    ttr = PPOTrainer(BatchedEnv(tenv, B, device="cpu", fused=fused), PPOConfig(**kw))
    return jtr, ttr


# ---------------------------------------------------------------- networks

@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_network_forward_matches_flax(dtype, atol):
    params = jax_params()
    obs = (2.0 * np.random.default_rng(1).normal(size=(256, OBS))).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    j_mean, j_log_std, j_value = jnet.ActorCritic(
        action_size=ACT, hidden=HIDDEN, compute_dtype=jdt
    ).apply(params, jnp.asarray(obs))
    net, _ = to_port(params, dtype=getattr(torch, dtype))
    with torch.no_grad():
        mean, log_std, value = net(t_(obs))
        np.testing.assert_allclose(net.policy_mean(t_(obs)).numpy(), mean.numpy(), rtol=0, atol=0)
        np.testing.assert_allclose(net.value(t_(obs)).numpy(), value.numpy(), rtol=0, atol=0)
    assert mean.dtype == value.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=0, atol=atol)
    np.testing.assert_allclose(log_std.detach().numpy(), np.asarray(j_log_std), rtol=0, atol=0)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=0, atol=atol)


def test_gaussian_logp_and_entropy_match():
    params = jax_params()
    net, _ = to_port(params)
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(64, ACT)).astype(np.float32)
    action = rng.normal(size=(64, ACT)).astype(np.float32)
    log_std = params["params"]["log_std"]
    j_logp = jnet.gaussian_logp(jnp.asarray(action), jnp.asarray(mean), log_std)
    t_logp = tnet.gaussian_logp(t_(action), t_(mean), net.log_std.detach())
    np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tnet.gaussian_entropy(net.log_std.detach())),
                               float(jnet.gaussian_entropy(log_std)), rtol=0, atol=1e-6)
    # sample_action: the same normals give the same action and log-prob
    noise = rng.normal(size=(64, ACT)).astype(np.float32)
    act, logp = tnet.sample_action(None, t_(mean), net.log_std.detach(), noise=t_(noise))
    want = mean + np.exp(np.asarray(log_std)) * noise
    np.testing.assert_allclose(act.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        logp.numpy(), np.asarray(jnet.gaussian_logp(jnp.asarray(want), jnp.asarray(mean), log_std)),
        rtol=0, atol=1e-6)


def test_init_is_seeded_orthogonal():
    a = tnet.ActorCritic(OBS, ACT, HIDDEN, device="cpu", seed=3)
    b = tnet.ActorCritic(OBS, ACT, HIDDEN, device="cpu", seed=3)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    w = a.actor[1].weight.detach()  # square: W W^T = gain^2 I
    torch.testing.assert_close(w @ w.T, 2.0 * torch.eye(HIDDEN[1]), rtol=0, atol=1e-5)
    head = a.actor_out.weight.detach()  # (A, h): orthonormal rows x 0.01
    torch.testing.assert_close(head @ head.T, 1e-4 * torch.eye(ACT), rtol=0, atol=1e-9)
    for p in (*(layer.bias for layer in (*a.actor, a.actor_out, a.critic_out)), a.log_std):
        assert not p.detach().any()


# ---------------------------------------------------------------- ObsNorm

def test_obs_norm_update_and_normalize_match():
    rng = np.random.default_rng(4)
    j = JaxObsNorm.init(OBS)
    t = ObsNorm.init(OBS, "cpu")
    for i in range(3):
        batch = (rng.normal(size=(64, OBS)) * (1 + i) + i).astype(np.float32)
        j = j.update(jnp.asarray(batch))
        t = t.update(t_(batch))
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    obs = (5 * rng.normal(size=(32, OBS))).astype(np.float32)
    np.testing.assert_allclose(t.normalize(t_(obs)).numpy(), np.asarray(j.normalize(jnp.asarray(obs))),
                               rtol=0, atol=1e-6)
    mom = [rng.normal(size=OBS).astype(np.float32), rng.uniform(size=OBS).astype(np.float32)]
    j2, t2 = j.update_moments(*map(jnp.asarray, mom), 1024), t.update_moments(*map(t_, mom), 1024)
    for a, b in zip(t2, j2):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- GAE

def random_traj(seed, n_t=16, b=32):
    """A (n_t, b) trajectory with term-only, trunc-only and both-set lanes."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    term = (rng.uniform(size=(n_t, b)) < 0.15).astype(np.float32)
    trunc = (rng.uniform(size=(n_t, b)) < 0.15).astype(np.float32)
    term[3, :4] = trunc[3, :4] = 1.0  # both set
    return dict(obs=f(n_t, b, OBS), action=f(n_t, b, ACT), logp=f(n_t, b), value=f(n_t, b),
                reward=f(n_t, b), term=term, trunc=trunc, boot_value=f(n_t, b)), f(b)


def test_gae_matches_associative_scan():
    jtr, ttr = trainers()
    traj, last = random_traj(5)
    assert (traj["term"] * (1 - traj["trunc"])).any() and (traj["trunc"] * (1 - traj["term"])).any()
    assert (traj["term"] * traj["trunc"]).any()
    j_adv, j_ret = jtr._gae(JaxTransition(**{k: jnp.asarray(v) for k, v in traj.items()}), jnp.asarray(last))
    t_adv, t_ret = ttr._gae(Transition(**{k: t_(v) for k, v in traj.items()}), t_(last))
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- loss

def test_loss_and_grads_match():
    jtr, ttr = trainers()
    params = jax_params(6)
    traj, _ = random_traj(7, n_t=4, b=16)
    traj["obs"] *= 0.5
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in traj.items()}
    rng = np.random.default_rng(8)
    adv = rng.normal(size=64).astype(np.float32)
    ret = rng.normal(size=64).astype(np.float32)
    (j_loss, j_m), j_grads = jax.value_and_grad(jtr._loss, has_aux=True)(
        params, JaxTransition(**{k: jnp.asarray(v) for k, v in flat.items()}),
        jnp.asarray(adv), jnp.asarray(ret))
    net, _ = to_port(params)
    t_loss, t_m = ttr._loss(net, Transition(**{k: t_(v) for k, v in flat.items()}), t_(adv), t_(ret))
    t_loss.backward()
    for k in j_m:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=0, atol=1e-5)
    assert_trees_close(port_grads(net), j_grads["params"], 1e-5, "grad ")


# ---------------------------------------------------------------- update phase

def jax_rollout_and_perms(jtr, state, key):
    """What the JAX ``train_step(state, key)`` draws: its trajectory,
    last_value and per-epoch permutations (recomputed from the key)."""
    cfg = jtr.cfg
    k_roll, k_perm = jax.random.split(key)
    _, obs, _, _, traj = jax.jit(jtr._rollout)(
        state.params, state.env_state, state.obs, state.env_key, state.obs_norm, k_roll)
    _, _, last_value = jtr.net.apply(state.params, state.obs_norm.normalize(obs.T))
    n = cfg.rollout_steps * (1 if cfg.minibatch_mode == "time" else jtr.benv.n_envs)
    perms = [jax.random.permutation(ek, n) for ek in jax.random.split(k_perm, cfg.num_epochs)]
    return (Transition(*(t_(x) for x in np_tree(traj))), t_(last_value),
            [t_(p).long() for p in perms])


@pytest.mark.parametrize("case,cfg_kwargs,n_updates", [
    ("shuffle", {}, 1),
    ("time", dict(minibatch_mode="time"), 1),
    ("anneal", dict(anneal_updates=2), 2),
    ("critic_warmup", dict(critic_warmup_updates=1), 2),
    ("bf16", {}, 1),
])
def test_update_phase_matches_train_step(monkeypatch, case, cfg_kwargs, n_updates):
    """The port's update phase against the JAX train_step on its own
    trajectory and permutations.  The first minibatch's loss terms (before
    any Adam step) match within 1e-6.  The "bf16" case runs both sides'
    default bf16 towers: there those terms are what tells bf16 towers from
    f32 ones (on the CPU the bf16 port is within 2e-8 of the JAX package;
    f32 towers miss by 3e-6 to 1.2e-5), while the params after the phase
    are held within BF16_UPDATE_ATOL, the bf16 rounding that 16 Adam steps
    amplify (7e-4 measured), which f32 towers meet as well."""
    bf16 = case == "bf16"
    jtr, ttr = trainers(cfg_kwargs)
    if bf16:
        jtr.net = jnet.ActorCritic(action_size=ACT, hidden=HIDDEN)  # flax's default compute dtype
    state = jtr.init(jax.random.PRNGKey(0))
    net, _ = to_port(state.params, dtype=torch.bfloat16 if bf16 else torch.float32)
    opt = ttr.make_optimizer(net)
    calls = []
    apply_minibatch = ttr._apply_minibatch

    def recorded(*args):
        calls.append((args[2:5], apply_minibatch(*args)))
        return calls[-1][1]

    monkeypatch.setattr(ttr, "_apply_minibatch", recorded)
    step = jax.jit(jtr.train_step)
    params0 = state.params
    for u in range(n_updates):
        key = jax.random.PRNGKey(10 + u)
        traj, last_value, perms = jax_rollout_and_perms(jtr, state, key)
        ttr._update(net, opt, traj, last_value, u, perms)
        state, _ = step(state, key)
        assert_trees_close(port_params(net), np_tree(state.params["params"]),
                           BF16_UPDATE_ATOL if bf16 else 1e-5, f"{case} update {u} ")
    (batch, adv, ret), t_m = calls[0]
    _, j_m = jtr._loss(params0, JaxTransition(*(jnp.asarray(x.numpy()) for x in batch)),
                       jnp.asarray(adv.numpy()), jnp.asarray(ret.numpy()))
    for k in j_m:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=0, atol=1e-6, err_msg=f"{case} {k}")
    if case == "critic_warmup":  # the actor moved only in the second update
        assert not np.allclose(np.asarray(state.params["params"]["actor_0"]["kernel"]),
                               np.asarray(jtr.init(jax.random.PRNGKey(0)).params["params"]["actor_0"]["kernel"]))


def test_lr_schedule_ticks_per_optimiser_step():
    _, ttr = trainers(dict(anneal_updates=3, num_epochs=2, num_minibatches=4))
    lrs = [ttr._lr(k) for k in range(26)]
    assert lrs[0] == 3e-4 and lrs[24] == 0.0 and lrs[25] == 0.0
    assert lrs[12] == pytest.approx(1.5e-4)


# ---------------------------------------------------------------- rollout

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_rollout_matches_through_truncations(fused):
    jtr, ttr = trainers(max_steps=4, fused=fused)
    state = jtr.init(jax.random.PRNGKey(0))
    state = state._replace(params=jax_params(9))
    key = jax.random.PRNGKey(5)
    _, _, _, j_mom, j_traj = jax.jit(jtr._rollout)(
        state.params, state.env_state, state.obs, state.env_key, state.obs_norm, key)

    # the JAX rollout's draws, as ppo.py and batch/vecenv.py make them
    benv = jtr.benv
    action_noise, env_noise = [], []
    env_key = state.env_key
    for step_key in jax.random.split(key, T):
        action_noise.append(np.asarray(jax.random.normal(step_key, (B, ACT))))
        env_step_key, env_key = jax.random.split(env_key)
        kt, kr = jax.random.split(env_step_key)
        env_noise.append(tuple(
            convert.noise_from_numpy(np_tree(jax_draw_noise(k, spec, batch=B)), device="cpu")
            for k, spec in ((kt, benv._t_spec), (kr, benv._r_spec))))

    net, obs_norm = to_port(state.params, state.obs_norm)
    env_state = convert.state_from_numpy(np_tree(state.env_state), VSSState, device="cpu")
    if fused:
        env_state = pack_vss_state(env_state)
    key_t = torch.tensor([1, 2, 0])
    _, _, key_after, t_mom, t_traj = ttr._rollout(
        net, env_state, t_(state.obs), key_t, obs_norm, None,
        draws=(t_(np.stack(action_noise)), env_noise))
    assert torch.equal(key_after, torch.tensor([1, 2, 0]))  # the draws replaced the key's

    j_traj = np_tree(j_traj)
    assert j_traj.trunc.sum() >= B, "expected truncations inside the rollout"
    for name in ("obs", "action", "logp", "value", "reward", "boot_value"):
        np.testing.assert_allclose(getattr(t_traj, name).numpy(), getattr(j_traj, name),
                                   rtol=0, atol=ENV_ATOL, err_msg=name)
    np.testing.assert_array_equal(t_traj.term.numpy(), j_traj.term)
    np.testing.assert_array_equal(t_traj.trunc.numpy(), j_traj.trunc)
    np.testing.assert_allclose(t_mom[0].numpy(), np.asarray(j_mom[0]), rtol=0, atol=ENV_ATOL)
    np.testing.assert_allclose(t_mom[1].numpy(), np.asarray(j_mom[1]), rtol=0, atol=ENV_ATOL)
    assert t_mom[2] == int(j_mom[2])


# ---------------------------------------------------------------- train_step

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_train_step_runs_and_updates(fused):
    ttr = PPOTrainer(rsoccer_tpu_torch.make_vec("VSS-v0", B, device="cpu", fused=fused, fused_rng="kernel"),
                     PPOConfig(rollout_steps=T, hidden=HIDDEN, num_epochs=2, num_minibatches=2))
    state = ttr.init(0)
    p0 = [p.detach().clone() for p in state.net.parameters()]
    state, m = ttr.train_step(state)
    assert state.update_step == 1 and int(state.env_key[2]) == 1 + T
    for k in ("loss", "policy_loss", "value_loss", "entropy", "mean_reward", "mean_episode_ends"):
        assert torch.isfinite(m[k]), k
    assert all(not torch.equal(a, b) for a, b in zip(p0, state.net.parameters()))
    assert float(state.obs_norm.count) == pytest.approx(1e-4 + T * B)
    ms = ttr.phase_ms()
    assert ms["collect_ms"] > 0 and ms["update_ms"] > 0


def test_fused_and_unfused_train_steps_agree():
    """Both paths read one Philox stream: the same seed gives the same
    update (the fused plain version is the unfused env step)."""
    out = []
    for fused in (False, True):
        ttr = PPOTrainer(rsoccer_tpu_torch.make_vec("VSS-v0", B, device="cpu", fused=fused),
                         PPOConfig(rollout_steps=T, hidden=HIDDEN, num_epochs=1, num_minibatches=2))
        state, _ = ttr.train_step(ttr.init(1))
        out.append([p.detach() for p in state.net.parameters()])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_time_mode_requires_divisibility():
    with pytest.raises(ValueError, match="divisible"):
        trainers(dict(rollout_steps=9, num_minibatches=2, minibatch_mode="time"))
    with pytest.raises(ValueError, match="minibatch_mode"):
        trainers(dict(minibatch_mode="rows"))


def test_policy_drives_rollout():
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.models.ppo import make_policy

    benv = rsoccer_tpu_torch.make_vec("VSS-v0", B, device="cpu", fused=True, fused_rng="kernel")
    net = tnet.ActorCritic(OBS, ACT, HIDDEN, device="cpu")
    for det in (True, False):
        carry, ms = R.make_rollout_fn(benv, 10, policy=make_policy(net, ObsNorm.init(OBS, "cpu"), det))(
            R.init_carry(benv, seed=3))
        assert torch.isfinite(ms.total_reward)


# ---------------------------------------------------------------- no fallback

def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    benv = BatchedEnv(rsoccer_tpu_torch.make("VSS-v0"), B)
    assert benv.supports_step_final
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPOTrainer(benv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnet.ActorCritic(OBS, ACT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ObsNorm.init(OBS)
