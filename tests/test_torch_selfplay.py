"""The port's self-play (``rsoccer_tpu_torch/envs/vss_selfplay.py``,
``rsoccer_tpu_torch/models/selfplay.py``) held against the JAX package's
on the CPU: the env's step through auto-resets (unfused and the
``fused_physics`` path's plain version), the mirror, the adapter's step
with a frozen opponent and OU lanes fed the JAX package's draws, a PPO
train step on the adapter (f32 towers), the payload's copies and its
save and resume, ``make_eval_fn(carry_init=)`` and the example.  B = 16,
towers (32, 32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu.envs.base import draw_noise as jax_draw_noise
from rsoccer_tpu.models import networks as jnet
from rsoccer_tpu.models.ppo import PPOConfig as JaxPPOConfig
from rsoccer_tpu.models.ppo import PPOTrainer as JaxPPOTrainer
from rsoccer_tpu.models.ppo import Transition as JaxTransition
from rsoccer_tpu.models.selfplay import SelfPlayBatchedEnv as JaxSelfPlay
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch import eval as teval
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.envs.base import draw_noise
from rsoccer_tpu_torch.envs.vss import VSSState
from rsoccer_tpu_torch.examples import selfplay_vss
from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer, make_policy
from rsoccer_tpu_torch.models.selfplay import SelfPlayBatchedEnv
from rsoccer_tpu_torch.ops.philox import make_key, philox_words
from rsoccer_tpu_torch.utils import checkpoint
from tests.test_torch_env_vss import assert_states_close, np_noise, vm
from tests.test_torch_multiagent import check_env_against_jax
from tests.test_torch_ppo import assert_trees_close, jax_rollout_and_perms, np_tree, port_params, t_, to_port

torch.set_num_threads(1)

SP = "VSSSelfPlay-v0"
B, T = 16, 8
HIDDEN = (32, 32)
OBS, ACT = 40, 6
ACT_ATOL = 1e-5  # the opponent's actions, f32 towers
STATE_ATOL = 5e-5  # the env's (tests/test_torch_env_vss.py)


def jax_net():
    return jnet.ActorCritic(action_size=ACT, hidden=HIDDEN, compute_dtype=jnp.float32)


def opponent_params(seed):
    """flax params whose policy acts: the orthogonal(0.01) head of a fresh
    net gives means inside VSS's 0.05 m/s wheel deadzone, so every leaf
    gets seeded noise and the head is scaled up."""
    params = jax_net().init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x) + 0.1 * rng.normal(size=x.shape).astype(np.float32)),
                          params)
    head = params["params"]["actor_out"]
    params["params"]["actor_out"] = {k: v * 20.0 for k, v in head.items()}
    return params


def port_net(params):
    net, _ = to_port(params)
    return net


def jax_step_noise(key, adapter):
    """What the JAX adapter's step(state, blue, key) draws: the OU lanes'
    normals, then the env's transition and reset blocks."""
    k_ou, key = jax.random.split(key)
    kt, kr = jax.random.split(key)
    benv = adapter.benv
    ou_noise = np.asarray(jax.random.normal(k_ou, (6, 2, adapter.n_envs)))
    return tuple(
        convert.noise_from_numpy(np_tree(jax_draw_noise(k, spec, batch=adapter.n_envs)), device="cpu")
        for k, spec in ((kt, benv._t_spec), (kr, benv._r_spec))
    ) + (torch.from_numpy(ou_noise.copy()),)


# ------------------------------------------------------------------ the env

@pytest.mark.parametrize("final", [False, True], ids=["step", "step_final"])
@pytest.mark.parametrize("fused_physics", [False, True], ids=["unfused", "fused_physics"])
def test_step_matches_jax_through_resets(fused_physics, final):
    assert check_env_against_jax(SP, fused_physics, final, max_steps=3) >= B


def test_noise_spec_and_key_schedule():
    """No transition noise; a step still draws its reset blocks from the
    key's step and advances it by one, whatever the spec (the schedule
    every env shares)."""
    env = rsoccer_tpu_torch.make(SP)
    assert env.transition_noise_spec() == {} == rsoccer_tpu.make(SP).transition_noise_spec()
    assert env.action_size == 12 and env.obs_size == OBS
    benv = BatchedEnv(env, B, device="cpu")
    key = make_key(4, device="cpu")
    st, _ = benv.reset(key)
    assert int(key[2]) == 1
    want = draw_noise(key.clone(), env.reset_noise_spec(), B)
    t_noise, r_noise = benv._draw(key)
    assert t_noise == {} and int(key[2]) == 2
    for k in want:
        assert torch.equal(r_noise[k], want[k])
    benv.step(st, torch.zeros((12, B)), key)
    assert int(key[2]) == 3
    with pytest.raises(ValueError, match="equal team sizes"):
        rsoccer_tpu_torch.make(SP, n_robots_yellow=2)


def test_mirror_is_an_involution_and_matches_jax():
    jenv, tenv = rsoccer_tpu.make(SP), rsoccer_tpu_torch.make(SP)
    rng = np.random.default_rng(2)
    noise = np_noise(rng, jenv.reset_noise_spec(), B)
    js = vm(jenv.reset_state)({k: jnp.asarray(v) for k, v in noise.items()})
    w = js.world
    w = w._replace(ball=w.ball._replace(v_x=jnp.asarray(rng.normal(size=B), jnp.float32),
                                        v_y=jnp.asarray(rng.normal(size=B), jnp.float32)),
                   robots=w.robots._replace(v_x=jnp.asarray(rng.normal(size=(6, B)), jnp.float32),
                                            v_y=jnp.asarray(rng.normal(size=(6, B)), jnp.float32),
                                            v_theta=jnp.asarray(rng.normal(size=(6, B)), jnp.float32)))
    js = js._replace(world=w)
    ts = convert.state_from_numpy(np_tree(js), VSSState, device="cpu")
    mirrored = tenv.mirror_world(ts.world)
    assert_states_close(ts._replace(world=mirrored), js._replace(world=vm(jenv.mirror_world)(js.world)),
                        atol=1e-6, tag="mirror")
    back = tenv.mirror_world(mirrored)
    assert_states_close(ts._replace(world=back), js, atol=1e-6, tag="mirror twice")
    np.testing.assert_allclose(tenv.observe_opponent(ts).numpy(), np.asarray(vm(jenv.observe_opponent)(js)),
                               rtol=0, atol=1e-6)
    # the opponent's view of a ball deep in +x is a ball deep in -x
    assert float(mirrored.ball.x[0]) == -float(ts.world.ball.x[0])


# -------------------------------------------------------------- the adapter

def adapters(ou_lanes, fused_physics=False, max_steps=None, opp_seed=3):
    jenv, tenv = rsoccer_tpu.make(SP), rsoccer_tpu_torch.make(SP)
    if max_steps is not None:
        jenv.max_episode_steps = tenv.max_episode_steps = max_steps
    params = opponent_params(opp_seed)
    ja = JaxSelfPlay(jenv, B, jax_net(), params, ou_lanes=ou_lanes)
    ta = SelfPlayBatchedEnv(tenv, B, port_net(params), ou_lanes=ou_lanes, device="cpu",
                            fused_physics=fused_physics)
    return ja, ta


@pytest.mark.parametrize("fused_physics", [False, True], ids=["unfused", "fused_physics"])
def test_adapter_step_matches_jax(fused_physics):
    """Several steps through auto-resets, half the lanes OU-driven: the
    yellow actions (the frozen policy's and the OU lanes'), the OU state,
    which the env carries unchanged and the adapter advances, and the
    full step, each fed the JAX adapter's own draws."""
    ja, ta = adapters(B // 2, fused_physics, max_steps=4)
    (j_inner, j_opp), j_obs = ja.reset(jax.random.PRNGKey(0))
    state = (convert.state_from_numpy(np_tree(j_inner), VSSState, device="cpu"), ta.payload_from(ta.net))
    rng = np.random.default_rng(1)
    j_step, j_yellow_actions = jax.jit(ja.step), jax.jit(ja._yellow_actions)
    dones = 0
    for t in range(7):
        blue = rng.uniform(-1, 1, (ACT, B)).astype(np.float32)
        key = jax.random.PRNGKey(100 + t)
        t_noise, r_noise, ou_noise = jax_step_noise(key, ja)
        # the yellow actions alone
        k_ou, _ = jax.random.split(key)
        j_in2, j_yellow = j_yellow_actions(j_inner, j_opp, k_ou)
        t_in2, t_yellow = ta._yellow_actions(state[0], state[1], ou_noise)
        np.testing.assert_allclose(t_yellow.numpy(), np.asarray(j_yellow), rtol=0, atol=ACT_ATOL, err_msg=f"t={t}")
        np.testing.assert_allclose(t_in2.ou_x.numpy(), np.asarray(j_in2.ou_x), rtol=0, atol=1e-6)
        ou_rows = t_in2.ou_x[3:].reshape(ACT, B)
        assert torch.equal(t_yellow[:, :B // 2], ou_rows[:, :B // 2])
        assert not torch.allclose(t_yellow[:, B // 2:], ou_rows[:, B // 2:], atol=1e-3)
        # the full step
        (j_inner, j_opp), j_obs, j_rew, j_term, j_trunc, j_info = j_step((j_inner, j_opp), jnp.asarray(blue), key)
        state, obs, rew, term, trunc, info = ta.step_with_noise(state, torch.from_numpy(blue), t_noise, r_noise,
                                                                ou_noise)
        tag = f"fused_physics={fused_physics} step {t}"
        assert_states_close(state[0], j_inner, atol=STATE_ATOL, tag=tag)
        np.testing.assert_allclose(obs.numpy(), np.asarray(j_obs), rtol=0, atol=STATE_ATOL, err_msg=tag)
        np.testing.assert_allclose(rew.numpy(), np.asarray(j_rew), rtol=0, atol=STATE_ATOL, err_msg=tag)
        np.testing.assert_array_equal(term.numpy(), np.asarray(j_term))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(j_trunc))
        for k in info:
            np.testing.assert_allclose(info[k].numpy(), np.asarray(j_info[k]), rtol=0, atol=STATE_ATOL)
        dones += int((term | trunc).sum())
    assert dones >= B


def test_opponent_bf16_forward_matches_flax():
    """The frozen net at the learner's default bf16 towers: the opponent's
    actions against flax's bf16 apply, at the bf16 forward's 1e-3
    (tests/test_torch_ppo.py)."""
    params = opponent_params(5)
    tenv = rsoccer_tpu_torch.make(SP)
    net, _ = to_port(params, dtype=torch.bfloat16)
    ta = SelfPlayBatchedEnv(tenv, B, net, device="cpu")
    ja = JaxSelfPlay(rsoccer_tpu.make(SP), B, jnet.ActorCritic(action_size=ACT, hidden=HIDDEN), params)
    (j_inner, j_opp), _ = ja.reset(jax.random.PRNGKey(1))
    inner = convert.state_from_numpy(np_tree(j_inner), VSSState, device="cpu")
    _, got = ta._yellow_actions(inner, ta.payload_from(net), None)
    _, want = ja._yellow_actions(j_inner, j_opp, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


def test_ou_normals_key_path():
    """On the key path the OU lanes' normals come from the batch's Philox
    key at the step's counter, from OU_LANES_BLOCK up: the key does not
    move, and the words are not the env step's."""
    _, ta = adapters(B)
    key = make_key(7, device="cpu")
    key[2] = 5
    n = ta.ou_normals(key)
    assert n.shape == (6, 2, B) and int(key[2]) == 5
    assert torch.equal(n, ta.ou_normals(key.clone()))
    assert not torch.equal(philox_words(key, 24, B), philox_words(key, 24, B, 1 << 31))
    st, _ = ta.reset(key)
    before = st[0].ou_x.clone()
    st, *_ = ta.step(st, torch.zeros((ACT, B)), key)
    assert int(key[2]) == 7 and not torch.equal(st[0].ou_x, before)


def test_ou_lanes_range_and_copies():
    with pytest.raises(ValueError, match="not in"):
        adapters(B + 1)
    with pytest.raises(ValueError, match="not in"):
        adapters(-1)
    _, ta = adapters(0)
    trainer = PPOTrainer(ta, PPOConfig(rollout_steps=T, hidden=HIDDEN, num_epochs=1, num_minibatches=2))
    state = trainer.init(0)
    payload = ta.payload_from(state.net, state.obs_norm)
    learner = dict(state.net.named_parameters())
    for k, v in payload.params.items():
        assert v.data_ptr() != learner[k].data_ptr() and torch.equal(v, learner[k])
    assert payload.norm_mean.data_ptr() != state.obs_norm.mean.data_ptr()
    swapped = SelfPlayBatchedEnv.swap_opponent(state, payload)
    inner_opp = swapped.env_state[1]
    for k in payload.params:
        assert inner_opp.params[k].data_ptr() != payload.params[k].data_ptr()
    before = {k: v.clone() for k, v in inner_opp.params.items()}
    swapped, _ = trainer.train_step(swapped)  # the learner's Adam steps in place
    for k in before:
        assert torch.equal(swapped.env_state[1].params[k], before[k])
        assert not torch.equal(learner[k], before[k]) or k == "log_std"


def test_eval_carry_init_swaps_the_payload():
    """make_eval_fn(carry_init=) scores the learner against the swapped-in
    opponent: the same numbers as an adapter built with that opponent."""
    env = rsoccer_tpu_torch.make(SP)
    env.max_episode_steps = 5
    a_net, b_net = port_net(opponent_params(3)), port_net(opponent_params(4))
    ev_a = SelfPlayBatchedEnv(env, B, a_net, device="cpu")
    ev_b = SelfPlayBatchedEnv(env, B, b_net, device="cpu")
    learner = port_net(opponent_params(5))
    policy = make_policy(learner)
    success = teval.success_criterion(SP)
    payload_b = ev_a.payload_from(b_net)
    swapped = teval.make_eval_fn(ev_a, 12, policy, success,
                                 carry_init=lambda c: c._replace(state=(c.state[0], payload_b)))(3)
    direct = teval.make_eval_fn(ev_b, 12, policy, success)(3)
    plain = teval.make_eval_fn(ev_a, 12, policy, success)(3)
    for f in teval.EvalMetrics._fields:
        assert torch.equal(getattr(swapped, f), getattr(direct, f)), f
    assert int(swapped.episodes) == 2 * B
    assert float(swapped.total_reward) != float(plain.total_reward)


# --------------------------------------------------------------------- PPO

def trainers(ou_lanes):
    ja, ta = adapters(ou_lanes, max_steps=5)
    kw = {"rollout_steps": T, "hidden": HIDDEN}
    jtr = JaxPPOTrainer(ja, JaxPPOConfig(**kw))
    jtr.net = jax_net()
    return jtr, PPOTrainer(ta, PPOConfig(**kw))


def test_ppo_train_step_matches_jax():
    """A PPO train step on the adapter, f32 towers, half the lanes OU: the
    rollout fed the JAX package's draws (the policy's normals, and per
    step the env blocks and the OU lanes' normals) gives the JAX
    trajectory, and the update phase on it the JAX train step's params
    within 1e-5, with the first minibatch's loss terms within 1e-6."""
    jtr, ttr = trainers(B // 2)
    state = jtr.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(11)
    k_roll, _ = jax.random.split(key)
    _, _, _, j_mom, j_traj = jax.jit(jtr._rollout)(
        state.params, state.env_state, state.obs, state.env_key, state.obs_norm, k_roll)
    action_noise, env_noise = [], []
    env_key = state.env_key
    for step_key in jax.random.split(k_roll, T):
        action_noise.append(np.asarray(jax.random.normal(step_key, (B, ACT))))
        env_step_key, env_key = jax.random.split(env_key)
        env_noise.append(jax_step_noise(env_step_key, jtr.benv))
    net, obs_norm = to_port(state.params, state.obs_norm)
    inner, opp = state.env_state
    env_state = (convert.state_from_numpy(np_tree(inner), VSSState, device="cpu"),
                 ttr.benv.payload_from(ttr.benv.net))
    _, _, _, t_mom, t_traj = ttr._rollout(net, env_state, t_(state.obs), torch.tensor([1, 2, 0]), obs_norm,
                                          None, draws=(t_(np.stack(action_noise)), env_noise))
    j_traj = np_tree(j_traj)
    assert j_traj.term.sum() + j_traj.trunc.sum() >= B
    for name in ("obs", "action", "logp", "value", "reward", "boot_value"):
        np.testing.assert_allclose(getattr(t_traj, name).numpy(), getattr(j_traj, name),
                                   rtol=0, atol=STATE_ATOL, err_msg=name)
    np.testing.assert_array_equal(t_traj.term.numpy(), j_traj.term)
    np.testing.assert_array_equal(t_traj.trunc.numpy(), j_traj.trunc)
    for a, b in zip(t_mom[:2], j_mom[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=STATE_ATOL)

    # the update phase on the JAX trajectory and permutations
    traj, last_value, perms = jax_rollout_and_perms(jtr, state, key)
    opt = ttr.make_optimizer(net)
    losses = []
    apply_minibatch = ttr._apply_minibatch

    def recorded(*args):
        losses.append((args[2:5], apply_minibatch(*args)))
        return losses[-1][1]

    ttr._apply_minibatch = recorded
    ttr._update(net, opt, traj, last_value, 0, perms)
    new_state, _ = jax.jit(jtr.train_step)(state, key)
    assert_trees_close(port_params(net), np_tree(new_state.params["params"]), 1e-5, "selfplay update ")
    (batch, adv, ret), t_m = losses[0]
    _, j_m = jtr._loss(state.params, JaxTransition(*(jnp.asarray(x.numpy()) for x in batch)),
                       jnp.asarray(adv.numpy()), jnp.asarray(ret.numpy()))
    for k in j_m:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=0, atol=1e-6, err_msg=k)


def test_train_resumes_bit_for_bit(tmp_path):
    """The whole self-play training state, the opponent's payload
    included, saved and restored: one more update from each gives the same
    bits (params, env state, payload, key)."""
    _, ta = adapters(B // 2, fused_physics=True, max_steps=6)
    trainer = PPOTrainer(ta, PPOConfig(rollout_steps=T, hidden=HIDDEN, num_epochs=1, num_minibatches=2,
                                       minibatch_mode="time"))
    state, _ = trainer.train_step(trainer.init(2))
    state = SelfPlayBatchedEnv.swap_opponent(state, ta.payload_from(state.net, state.obs_norm))
    path = str(tmp_path / "sp")
    checkpoint.save(path, trainer.state_tree(state))
    back = trainer.state_from_tree(checkpoint.restore(path, like=trainer.state_tree(state)))
    s1, m1 = trainer.train_step(state)
    s2, m2 = trainer.train_step(back)
    for a, b in zip(s1.net.parameters(), s2.net.parameters()):
        assert torch.equal(a, b)
    leaves = checkpoint.flatten
    for a, b in zip(leaves(s1.env_state), leaves(s2.env_state)):
        assert torch.equal(a, b)
    assert len(leaves(s1.env_state[1])) == len(list(state.net.parameters())) + 2
    assert torch.equal(s1.env_key, s2.env_key) and torch.equal(m1["loss"], m2["loss"])


def test_example_runs_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "league")
    selfplay_vss.main(["--device", "cpu", "--envs", "8", "--updates", "2", "--swap-every", "1",
                       "--rollout-steps", "8", "--eval-steps", "3", "--eval-envs", "4", "--hidden", "32,32",
                       "--ou-frac", "0.5", "--anchor-gate", "--anchor-envs", "4", "--anchor-steps", "3",
                       "--minibatch-mode", "time", "--save", path])
    out = capsys.readouterr().out
    assert "goalrate_vs_frozen" in out and "saved BEST-anchor" in out
    net, obs_norm = convert.load_ppo_checkpoint(path + ".npz", device="cpu")
    assert (net.obs_size, net.action_size, net.hidden) == (OBS, ACT, HIDDEN)
    args = selfplay_vss.build_parser().parse_args(["--device", "cpu"])
    assert args.fused_physics is None and args.ou_frac == 0.0 and args.anchor_margin == 0.02
