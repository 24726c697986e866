"""The port's SSLDribbling-v0 and SSLPassEndurance-v0 env functions vs the
JAX package's, fed the same noise: reset, observe, transition,
step_with_noise(_final) through auto-resets, and the training-time
extensions (DR and PE curriculum, PE catch_scale and aim_shaping)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.envs.ssl_dribbling import DribblingState
from tests.test_torch_env_ssl import ATOL, assert_states_close, jx, np_noise, tx, vm

torch.set_num_threads(1)

B = 16
DR, PE = "SSLDribbling-v0", "SSLPassEndurance-v0"


def pair(env_id, max_steps=None, **kw):
    jenv, tenv = rsoccer_tpu.make(env_id, **kw), rsoccer_tpu_torch.make(env_id, **kw)
    if max_steps is not None:
        jenv.max_episode_steps = tenv.max_episode_steps = max_steps
    return jenv, tenv


def noise(rng, spec):
    """np_noise, with the pad block an empty spec draws (a deterministic
    reset takes its batch from it)."""
    return np_noise(rng, spec, B) if spec else {"_pad": np.zeros((1, B), np.float32)}


def dr_states(rng, b=B):
    """Mid-course DR worlds: the ball just across y = 0 next to a gate,
    moving across it, for every checkpoint count 0..7, the robot behind it."""
    jenv = rsoccer_tpu.make(DR)
    s = vm(jenv.reset_state)({"_pad": jnp.zeros((1, b))})
    count = rng.integers(0, 8, b)
    gate_x = np.select([count == 0, count == 1, count % 2 == 0], [-0.75, -1.25, -1.75], -2.5)
    up = (count == 1) | ((count >= 2) & (count % 2 == 1)) | (rng.uniform(size=b) < 0.25)
    by = np.where(up, -0.01, 0.01).astype(np.float32)
    bvy = np.where(up, 0.8, -0.8).astype(np.float32)
    bx = (gate_x + rng.uniform(-0.15, 0.15, b)).astype(np.float32)
    w, rb = s.world, s.world.robots
    ball = w.ball._replace(x=jnp.asarray(bx), y=jnp.asarray(by), v_y=jnp.asarray(bvy),
                           v_x=jnp.asarray(rng.uniform(-0.3, 0.3, b).astype(np.float32)))
    robots = rb._replace(x=rb.x.at[0].set(jnp.asarray(bx + 0.2)), y=rb.y.at[0].set(jnp.asarray(by)))
    return s._replace(world=w._replace(ball=ball, robots=robots),
                      checkpoints=jnp.asarray(count, jnp.int32))


@pytest.mark.parametrize("env_id", [DR, PE])
def test_env_constants_equal_jax(env_id):
    jenv, tenv = pair(env_id)
    names = ["obs_size", "action_size", "max_episode_steps", "n_robots", "n_blue", "max_pos",
             "max_v", "max_w_cmd", "max_w_norm", "time_step", "norm_bounds"]
    if env_id == PE:
        names += ["max_kick_x", "ball_grad_scale", "catch_scale", "aim_shaping"]
    for name in names:
        assert getattr(tenv, name) == getattr(jenv, name), name
    assert tenv.reset_noise_spec() == jenv.reset_noise_spec()
    assert tenv.transition_noise_spec() == jenv.transition_noise_spec()
    assert rsoccer_tpu_torch.make(env_id, curriculum=True).reset_noise_spec() == \
        rsoccer_tpu.make(env_id, curriculum=True).reset_noise_spec()


@pytest.mark.parametrize(
    "env_id, kw",
    [(DR, {}), (PE, {}), (DR, {"curriculum": True}), (PE, {"curriculum": True})],
    ids=["DR", "PE", "DR_curriculum", "PE_curriculum"],
)
def test_reset_state_and_observe_match_jax(env_id, kw):
    jenv, tenv = pair(env_id, **kw)
    n = noise(np.random.default_rng(0), jenv.reset_noise_spec())
    js = vm(jenv.reset_state)(jx(n))
    ts = tenv.reset_state(tx(n))
    assert_states_close(ts, js, atol=1e-6)
    np.testing.assert_allclose(tenv.observe(ts).numpy(), np.asarray(vm(jenv.observe)(js)), atol=1e-6)


@pytest.mark.parametrize("final", [False, True], ids=["step", "step_final"])
@pytest.mark.parametrize("max_steps", [None, 3], ids=["limit_default", "limit3"])
@pytest.mark.parametrize("env_id", [DR, PE])
def test_step_with_noise_matches_jax(env_id, max_steps, final):
    jenv, tenv = pair(env_id, max_steps)
    check_steps(jenv, tenv, final, np.random.default_rng(7 if max_steps else 8),
                need_done=max_steps is not None, key=(env_id, max_steps))


@pytest.mark.parametrize(
    "env_id, kw",
    [(DR, {"curriculum": True}), (PE, {"curriculum": True}), (PE, {"catch_scale": 3.0}),
     (PE, {"aim_shaping": 0.5})],
    ids=["DR_curriculum", "PE_curriculum", "PE_catch_scale", "PE_aim_shaping"],
)
def test_training_extensions_match_jax(env_id, kw):
    jenv, tenv = pair(env_id, 4, **kw)
    check_steps(jenv, tenv, False, np.random.default_rng(9), need_done=True,
                key=(env_id, 4, tuple(kw.items())))


def test_dr_gate_window_matches_jax():
    """From worlds built next to each gate with counts 0..7: crossings,
    reverse-gate terminations and completions happen, and agree."""
    jenv, tenv = pair(DR)
    rng = np.random.default_rng(4)
    js = dr_states(rng, 64)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), DribblingState, device="cpu")
    act = np.zeros((4, 64), np.float32)
    act[3] = 1.0
    jo = jax.jit(vm(jenv.transition))(js, jnp.asarray(act), {})
    to = tenv.transition(ts, torch.from_numpy(act), {})
    assert_states_close(to[0], jo[0])
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=ATOL)
    np.testing.assert_array_equal(to[2].numpy(), np.asarray(jo[2]))
    crossed = to[1].numpy() > 0.5
    count = np.asarray(js.checkpoints)
    assert crossed.sum() >= 8 and (to[0].checkpoints.numpy() == 7).any()
    assert (to[2].numpy() & ~crossed & (count >= 2)).any()  # reverse-gate ends


_JAX_STEP_FINAL = {}


def jax_step_final(jenv, key):
    """The JAX env's jitted step_with_noise_final, one compile per
    configuration (its outputs hold step_with_noise's)."""
    if key not in _JAX_STEP_FINAL:
        _JAX_STEP_FINAL[key] = jax.jit(vm(jenv.step_with_noise_final))
    return _JAX_STEP_FINAL[key]


def check_steps(jenv, tenv, final, rng, need_done, key, n_steps=6):
    r0 = noise(rng, jenv.reset_noise_spec())
    js = vm(jenv.reset_state)(jx(r0))
    ts = tenv.reset_state(tx(r0))
    j_full = jax_step_final(jenv, key)
    j_fn = j_full if final else (lambda *a: (lambda o: o[:2] + o[3:])(j_full(*a)))
    t_fn = tenv.step_with_noise_final if final else tenv.step_with_noise
    saw_done = False
    for t in range(n_steps):
        act = rng.uniform(-1, 1, (tenv.action_size, B)).astype(np.float32)
        tn = noise(rng, jenv.transition_noise_spec())
        rn = noise(rng, jenv.reset_noise_spec())
        jo = j_fn(js, jnp.asarray(act), jx(tn), jx(rn))
        to = t_fn(ts, torch.from_numpy(act), tx(tn), tx(rn))
        js, ts = jo[0], to[0]
        tag = f"step {t}"
        assert_states_close(ts, js, tag=tag)
        n_obs = 2 if final else 1
        for k in range(1, 1 + n_obs):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=ATOL, err_msg=tag)
        rew, term, trunc, info = to[1 + n_obs:]
        j_rew, j_term, j_trunc, j_info = jo[1 + n_obs:]
        np.testing.assert_allclose(rew.numpy(), np.asarray(j_rew), atol=ATOL, err_msg=tag)
        np.testing.assert_array_equal(term.numpy(), np.asarray(j_term), err_msg=tag)
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(j_trunc), err_msg=tag)
        assert set(info) == set(j_info)
        for k in info:
            np.testing.assert_allclose(info[k].numpy(), np.asarray(j_info[k]), atol=ATOL, err_msg=f"{tag} {k}")
        saw_done = saw_done or bool((term | trunc).any())
    if need_done:
        assert saw_done
