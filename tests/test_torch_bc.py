"""The port's behavior-cloning tool (``rsoccer_tpu_torch/tools/bc_warmstart.py``)
held against the JAX package's ``tools/bc_warmstart.py`` on the CPU: the
fit for both actor formats from the same initial params on the same pairs
and permutations, the SAC atanh target, the residual-std surgery, the
DAgger labels, the ``n < minibatch`` refusal, and ``main()`` end to end
with its checkpoint read back by both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rsoccer_tpu_torch
from rsoccer_tpu.models.networks import ActorCritic as JaxActorCritic
from rsoccer_tpu.models.ppo import ObsNorm as JaxObsNorm
from rsoccer_tpu.models.sac import SquashedGaussianActor as JaxSquashedGaussianActor
from rsoccer_tpu.utils import checkpoint as jax_checkpoint
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.experts import EXPERTS
from rsoccer_tpu_torch.models import ppo as tppo
from rsoccer_tpu_torch.models import sac as tsac
from rsoccer_tpu_torch.models.networks import ActorCritic
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.tools import bc_warmstart as bc
from tests.test_torch_ppo import BF16_UPDATE_ATOL, assert_trees_close

torch.set_num_threads(1)

PE = "SSLPassEndurance-v0"
OBS, ACT = 16, 3  # PassEndurance
HIDDEN = (32, 32)
N, MINIBATCH, EPOCHS = 640, 128, 3  # 5 minibatches per epoch, 128 pairs dropped
LR = 1e-3  # the tool's default
F32_ATOL = 1e-5
# PPO's forward and loss in bf16 towers (tests/test_torch_ppo.py)
BF16_FORWARD_ATOL = 1e-3


# ------------------------------------------- the JAX tool's fit, restated
def jax_fit(net, tx, minibatch, epochs):
    """tools/bc_warmstart.py:137-165 verbatim (a closure of its main(); its
    ``args.minibatch`` and ``args.epochs`` are the arguments here)."""

    def fit(params, Xn, Y, key):
        n = Xn.shape[0]
        opt_state = tx.init(params)

        def loss_fn(params, x, y):
            mean = net.apply(params, x)[0]
            return jnp.mean((mean - y) ** 2)

        def train_epoch(carry, ek):
            params, opt_state = carry
            perm = jax.random.permutation(ek, n)
            nb = n // minibatch
            idxs = perm[: nb * minibatch].reshape(nb, minibatch)

            def mb(carry, idx):
                params, opt_state = carry
                l, grads = jax.value_and_grad(loss_fn)(params, Xn[idx], Y[idx])
                updates, opt_state = tx.update(grads, opt_state, params)
                return (optax.apply_updates(params, updates), opt_state), l

            (params, opt_state), ls = jax.lax.scan(mb, (params, opt_state), idxs)
            return (params, opt_state), ls.mean()

        eks = jax.random.split(key, epochs)
        (params, _), ls = jax.lax.scan(train_epoch, (params, opt_state), eks)
        return params, ls

    return jax.jit(fit)


def jax_perms(key, n, epochs):
    """The permutations the JAX fit draws inside its scan."""
    return [torch.from_numpy(np.asarray(jax.random.permutation(ek, n)).astype(np.int64))
            for ek in jax.random.split(key, epochs)]


def jax_residual_std(net, params, Xn, Y, target):
    """tools/bc_warmstart.py:204-220 (the surgery on the fitted params)."""
    mean = net.apply(params, Xn)[0]
    resid = jnp.sqrt(jnp.mean((mean - Y) ** 2, axis=0))
    log_std = jnp.log(jnp.clip(resid, 0.1, 1.0))
    if target == "sac":
        def _set(path, v):
            keys = [getattr(pp, "key", getattr(pp, "name", "")) for pp in path]
            if "log_std" in keys:
                return jnp.zeros_like(v) if v.ndim == 2 else log_std
            return v

        params = jax.tree_util.tree_map_with_path(_set, params)
    else:
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: log_std if p[-1].key == "log_std" else v, params
        )
    return params, resid


# ------------------------------------------------------------------ nets
def jax_net(target, dtype):
    if target == "sac":
        return JaxSquashedGaussianActor(action_size=ACT, hidden=HIDDEN)
    return JaxActorCritic(action_size=ACT, hidden=HIDDEN, compute_dtype=dtype)


def to_port(target, params, dtype):
    """JAX params -> the port's net on the CPU (through the checkpoint leaf
    tables)."""
    if target == "sac":
        return convert.sac_actor_from_leaves([np.asarray(x) for x in jax.tree.leaves(params)],
                                             device="cpu")
    leaves = jax.tree.leaves({"params": params, "obs_norm": JaxObsNorm.init(OBS)})
    return convert.ppo_from_leaves([np.asarray(x) for x in leaves], device="cpu",
                                   compute_dtype=dtype)[0]


def from_port(target, net):
    if target == "sac":
        return convert.sac_actor_to_numpy(net)
    return convert.ppo_to_numpy(net, tppo.ObsNorm.init(OBS, "cpu"))["params"]


def pairs(target, seed=0):
    """Seeded (X, Y) like the tool's: obs in [-1.2, 1.2], expert actions
    in [-1, 1] with a saturated share (the SAC target clips those)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.2, 1.2, (N, OBS)).astype(np.float32)
    Y = np.clip(rng.normal(0.0, 0.7, (N, ACT)), -1.0, 1.0).astype(np.float32)
    return X, Y


CASES = [("ppo", "float32", F32_ATOL, F32_ATOL), ("ppo", "bfloat16", BF16_UPDATE_ATOL, BF16_FORWARD_ATOL),
         ("sac", "float32", F32_ATOL, F32_ATOL)]


@pytest.mark.parametrize("target, dtype, p_atol, l_atol", CASES, ids=["ppo_f32", "ppo_bf16", "sac"])
def test_fit_matches_jax(target, dtype, p_atol, l_atol):
    """Both fits from JAX's initial params on the same normalised pairs and
    JAX's own permutations: per-epoch losses and the fitted params."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    net = jax_net(target, jdt)
    params = net.init(jax.random.PRNGKey(1), jnp.zeros((1, OBS)))
    X, Y = pairs(target)
    if target == "sac":
        obs_norm = JaxObsNorm.init(OBS)
        Yt = jnp.arctanh(jnp.clip(jnp.asarray(Y), -0.999, 0.999))
    else:
        obs_norm = JaxObsNorm.init(OBS).update(jnp.asarray(X))
        Yt = jnp.asarray(Y)
    Xn = obs_norm.normalize(jnp.asarray(X))
    key = jax.random.PRNGKey(2)
    j_params, j_ls = jax_fit(net, optax.adam(LR), MINIBATCH, EPOCHS)(params, Xn, Yt, key)

    tnet = to_port(target, params, getattr(torch, dtype))
    t_ls = bc.fit(tnet, torch.from_numpy(np.array(Xn)), torch.from_numpy(np.array(Yt)),
                  jax_perms(key, N, EPOCHS), LR, MINIBATCH)
    assert t_ls.shape == (EPOCHS,)
    np.testing.assert_allclose(t_ls.detach().numpy(), np.asarray(j_ls), rtol=0, atol=l_atol)
    assert_trees_close(from_port(target, tnet), j_params, p_atol, f"{target} {dtype} ")
    assert float(t_ls[-1]) < float(t_ls[0])


@pytest.mark.parametrize("target", ["ppo", "sac"])
def test_atanh_target_and_residual_std_match_jax(target):
    """The SAC target atanh(clip(Y, +-0.999)), and the residual-std surgery:
    PPO's log_std parameter, SAC's log_std head (kernel zeroed, bias set)."""
    X, Y = pairs(target, seed=3)
    np.testing.assert_allclose(bc.atanh_target(torch.from_numpy(Y)).numpy(),
                               np.asarray(jnp.arctanh(jnp.clip(jnp.asarray(Y), -0.999, 0.999))),
                               rtol=0, atol=F32_ATOL)
    net = jax_net(target, jnp.float32)
    params = net.init(jax.random.PRNGKey(4), jnp.zeros((1, OBS)))
    # targets off the net's own mean by ~0.01, 0.5 and 2 per dim: the
    # residuals cross both clip ends (0.1 and 1)
    mean = np.asarray(net.apply(params, jnp.asarray(X))[0])
    noise = np.random.default_rng(5).normal(size=mean.shape) * np.array([0.01, 0.5, 2.0])
    Yt = (mean + noise).astype(np.float32)
    j_params, j_resid = jax_residual_std(net, params, jnp.asarray(X), jnp.asarray(Yt), target)
    tnet = to_port(target, params, torch.float32)
    t_resid = bc.set_residual_std(tnet, torch.from_numpy(X), torch.from_numpy(Yt))
    np.testing.assert_allclose(t_resid.numpy(), np.asarray(j_resid), rtol=0, atol=F32_ATOL)
    assert_trees_close(from_port(target, tnet), j_params, F32_ATOL, f"{target} surgery ")
    log_std = (tnet.log_std if target == "ppo" else tnet.log_std.bias).detach().numpy()
    np.testing.assert_allclose(np.exp(log_std[[0, 2]]), [0.1, 1.0], rtol=1e-6)
    assert 0.1 < np.exp(log_std[1]) < 1.0


def test_fit_refuses_fewer_pairs_than_a_minibatch():
    """The JAX tool runs zero minibatches there, returns the params
    untouched and prints a nan loss; the port raises, naming both."""
    net = ActorCritic(OBS, ACT, HIDDEN, device="cpu")
    X, Y = torch.zeros((100, OBS)), torch.zeros((100, ACT))
    with pytest.raises(ValueError, match=r"100 pairs .*--minibatch 128"):
        bc.fit(net, X, Y, [torch.randperm(100)], LR, 128)
    # the reference fault, shown: the JAX fit returns its params untouched and a nan loss
    jnet = jax_net("ppo", jnp.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    j_params, j_ls = jax_fit(jnet, optax.adam(LR), 128, 1)(params, jnp.zeros((100, OBS)),
                                                          jnp.zeros((100, ACT)), jax.random.PRNGKey(0))
    assert np.isnan(np.asarray(j_ls)).all()
    assert_trees_close(j_params, params, 0.0)


@pytest.mark.parametrize("curriculum", [1, 0], ids=["curriculum_unfused", "reference_fused"])
@pytest.mark.parametrize("target", ["ppo", "sac"])
def test_dagger_labels_are_the_expert_on_the_clones_states(target, curriculum):
    """collect(behavior="policy") acts with the clone and labels every state
    it visits with the expert: replayed step by step, X is the obs and Y
    the expert's action on that state, while the actions taken are the
    clone's (the trajectory leaves the expert's)."""
    benv = rsoccer_tpu_torch.make_vec(PE, 8, device="cpu", fused=not curriculum,
                                      fused_rng="kernel", curriculum=bool(curriculum))
    expert = EXPERTS[PE](benv.env)
    if target == "sac":
        net = tsac.SquashedGaussianActor(OBS, ACT, HIDDEN, device="cpu")
        obs_norm = None
    else:
        net = ActorCritic(OBS, ACT, HIDDEN, device="cpu", seed=3)
        obs_norm = tppo.ObsNorm.init(OBS, "cpu")
    T = 6
    X, Y = bc.collect(benv, expert, T, seed=5, behavior="policy", net=net, obs_norm=obs_norm)
    Xe, _ = bc.collect(benv, expert, T, seed=5)
    assert X.shape == (T * 8, OBS) and Y.shape == (T * 8, ACT)

    act = bc.clone_policy(net, obs_norm)
    key = make_key(5, device="cpu")
    state, obs = benv.reset(key)
    for t in range(T):
        view = benv.unpack_state(state) if benv.fused else state
        rows = slice(t * 8, (t + 1) * 8)
        torch.testing.assert_close(X[rows], obs.T, rtol=0, atol=0)
        torch.testing.assert_close(Y[rows], expert(view).T, rtol=0, atol=0)
        state, obs, *_ = benv.step(state, act(None, obs), key)
    torch.testing.assert_close(X[:8], Xe[:8], rtol=0, atol=0)  # the same reset
    assert not torch.equal(X[8:], Xe[8:])


@pytest.mark.parametrize("target", ["ppo", "sac"])
def test_main_checkpoint_loads_in_both_packages(target, tmp_path):
    """main() at a toy size on the CPU; its checkpoint loads through
    convert.load_{ppo,sac}_checkpoint and through the JAX package's
    checkpoint.restore(path, like=...), and both give the same actions."""
    path = str(tmp_path / f"{target}.ckpt")
    out = bc.run(bc.build_parser().parse_args([
        "--env-id", PE, "--device", "cpu", "--envs", "16", "--steps", "8", "--epochs", "2",
        "--minibatch", "32", "--dagger-iters", "1", "--target", target, "--save", path,
        "--eval-steps", "8",
    ]))
    assert out["pairs"] == [128, 256]
    assert len(out["mse"]) == 2 and all(len(m) == 2 and np.isfinite(m).all() for m in out["mse"])
    assert len(out["resid_std"]) == ACT and out["eval"]["n_steps"] == 8
    obs = np.random.default_rng(6).uniform(-1.2, 1.2, (32, OBS)).astype(np.float32)
    if target == "sac":
        actor = convert.load_sac_checkpoint(path + ".npz", device="cpu")
        got = tsac.make_policy(actor)(None, torch.from_numpy(obs.T)).numpy()
        jnet = JaxSquashedGaussianActor(action_size=ACT)
        like = {"actor_params": jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))}
        tree = jax_checkpoint.restore(path + ".npz", like=like)
        want = np.asarray(jnp.tanh(jnet.apply(tree["actor_params"], jnp.asarray(obs))[0])).T
        atol = F32_ATOL
        assert np.all(np.asarray(tree["actor_params"]["params"]["log_std"]["kernel"]) == 0)
    else:
        net, obs_norm = convert.load_ppo_checkpoint(path + ".npz", device="cpu")
        got = tppo.make_policy(net, obs_norm)(None, torch.from_numpy(obs.T)).numpy()
        jnet = JaxActorCritic(action_size=ACT)
        like = {"params": jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS))),
                "obs_norm": JaxObsNorm.init(OBS)}
        tree = jax_checkpoint.restore(path + ".npz", like=like)
        mean = jnet.apply(tree["params"], tree["obs_norm"].normalize(jnp.asarray(obs)))[0]
        want = np.asarray(jnp.clip(mean, -1.0, 1.0)).T
        atol = BF16_FORWARD_ATOL
        np.testing.assert_allclose(np.asarray(tree["params"]["params"]["log_std"]),
                                   np.log(np.clip(out["resid_std"], 0.1, 1.0)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_main_defaults_to_the_card():
    """Without --device the tool runs on 'cuda' and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bc.main(["--env-id", PE, "--save", "unused"])
