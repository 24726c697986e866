"""The port's SSLStaticDefenders-v0 and SSLContestedPossession-v0 env
functions vs the JAX package's, fed the same noise: reset, observe,
transition, step_with_noise(_final) through auto-resets, SD's training-time
curriculum and terminal penalty; and the copied SSL tables."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu.core import field as jfield
from rsoccer_tpu.physics import config as jconfig
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.core import field as tfield
from rsoccer_tpu_torch.physics import config as tconfig

torch.set_num_threads(1)

B = 16
ATOL = 5e-5
SSL_IDS = ["SSLStaticDefenders-v0", "SSLContestedPossession-v0"]
THETA_LEAF = 8  # ball 6 leaves, then robots x, y, theta


def np_noise(rng, spec, b):
    out = {}
    for name, (shape, kind) in spec.items():
        draw = rng.uniform(size=shape + (b,)) if kind == "uniform" else rng.normal(size=shape + (b,))
        out[name] = draw.astype(np.float32)
    return out


def pair(env_id, max_steps=None, **kw):
    jenv, tenv = rsoccer_tpu.make(env_id, **kw), rsoccer_tpu_torch.make(env_id, **kw)
    if max_steps is not None:
        jenv.max_episode_steps = tenv.max_episode_steps = max_steps
    return jenv, tenv


def vm(fn):
    return jax.vmap(fn, in_axes=-1, out_axes=-1)


def jx(noise):
    return {k: jnp.asarray(v) for k, v in noise.items()}


def tx(noise):
    return convert.noise_from_numpy(noise, device="cpu")


def assert_states_close(port_state, jax_state, atol=ATOL, tag=""):
    got = jax.tree.leaves(convert.state_to_numpy(port_state))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jax_state))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (tag, i)
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} leaf {i}")
            continue
        if i == THETA_LEAF:  # same angle across the +-pi wrap
            g = np.remainder(g - w + np.pi, 2 * np.pi) - np.pi
            w = np.zeros_like(w)
        np.testing.assert_allclose(g, w, atol=atol, err_msg=f"{tag} leaf {i}")


@pytest.mark.parametrize(
    "port, ref",
    [(tfield.ssl_field(ft), jfield.ssl_field(ft)) for ft in (0, 1, 2)]
    + [(tconfig.SSL_PHYSICS, jconfig.SSL_PHYSICS)],
    ids=["ssl_field0", "ssl_field1", "ssl_field2", "SSL_PHYSICS"],
)
def test_copied_ssl_tables_equal_jax(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if isinstance(port, tfield.FieldParams):
        for name in ("half_length", "half_width", "max_pos", "max_wheel_rad_s", "max_v"):
            assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("env_id", SSL_IDS)
def test_env_constants_equal_jax(env_id):
    jenv, tenv = pair(env_id)
    for name in ("obs_size", "action_size", "max_episode_steps", "n_robots", "max_pos",
                 "max_v", "max_w_cmd", "max_w_norm", "kick_speed_x", "ball_dist_scale",
                 "ball_grad_scale", "energy_scale", "time_step"):
        assert getattr(tenv, name) == getattr(jenv, name), name
    assert dataclasses.asdict(tenv.field) == dataclasses.asdict(jfield.ssl_field(2))
    assert tenv.reset_noise_spec() == jenv.reset_noise_spec()
    assert tenv.transition_noise_spec() == jenv.transition_noise_spec()


@pytest.mark.parametrize(
    "env_id, kw",
    [(SSL_IDS[0], {}), (SSL_IDS[1], {}), (SSL_IDS[0], {"curriculum": True})],
    ids=["SD", "CP", "SD_curriculum"],
)
def test_reset_state_and_observe_match_jax(env_id, kw):
    jenv, tenv = pair(env_id, **kw)
    noise = np_noise(np.random.default_rng(0), jenv.reset_noise_spec(), B)
    js = vm(jenv.reset_state)(jx(noise))
    ts = tenv.reset_state(tx(noise))
    assert_states_close(ts, js, atol=1e-6)
    np.testing.assert_allclose(tenv.observe(ts).numpy(), np.asarray(vm(jenv.observe)(js)), atol=1e-6)
    if kw:  # the curriculum moved some balls
        plain = tenv.__class__().reset_state(tx(noise))
        assert not torch.equal(plain.world.ball.x, ts.world.ball.x)


@pytest.mark.parametrize("final", [False, True], ids=["step", "step_final"])
@pytest.mark.parametrize("max_steps", [None, 3], ids=["limit_default", "limit3"])
@pytest.mark.parametrize("env_id", SSL_IDS)
def test_step_with_noise_matches_jax(env_id, max_steps, final):
    jenv, tenv = pair(env_id, max_steps)
    check_steps(jenv, tenv, final, np.random.default_rng(7 if max_steps else 8),
                need_done=max_steps is not None)


@pytest.mark.parametrize("kw", [{"curriculum": True}, {"terminal_penalty": 0.5}],
                         ids=["curriculum", "terminal_penalty"])
def test_sd_training_extensions_match_jax(kw):
    jenv, tenv = pair("SSLStaticDefenders-v0", 3, **kw)
    check_steps(jenv, tenv, False, np.random.default_rng(9), need_done=True)


def check_steps(jenv, tenv, final, rng, need_done, n_steps=8):
    r0 = np_noise(rng, jenv.reset_noise_spec(), B)
    js = vm(jenv.reset_state)(jx(r0))
    ts = tenv.reset_state(tx(r0))
    j_fn = vm(jenv.step_with_noise_final if final else jenv.step_with_noise)
    t_fn = tenv.step_with_noise_final if final else tenv.step_with_noise
    saw_done = False
    for t in range(n_steps):
        # strong actions: kicks, dribbling and terminations inside the window
        act = rng.uniform(-1, 1, (tenv.action_size, B)).astype(np.float32)
        tn = np_noise(rng, jenv.transition_noise_spec(), B)
        rn = np_noise(rng, jenv.reset_noise_spec(), B)
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


@pytest.mark.parametrize("env_id", SSL_IDS)
def test_transition_matches_jax(env_id):
    """One transition from a stepped (moving) state: next state, reward,
    terminated and info, before any auto-reset."""
    jenv, tenv = pair(env_id)
    rng = np.random.default_rng(3)
    r0 = np_noise(rng, jenv.reset_noise_spec(), B)
    js, ts = vm(jenv.reset_state)(jx(r0)), tenv.reset_state(tx(r0))
    for _ in range(2):
        act = rng.uniform(-1, 1, (tenv.action_size, B)).astype(np.float32)
        jo = vm(jenv.transition)(js, jnp.asarray(act), {})
        to = tenv.transition(ts, torch.from_numpy(act), {})
        assert_states_close(to[0], jo[0])
        np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=ATOL)
        np.testing.assert_array_equal(to[2].numpy(), np.asarray(jo[2]))
        for k in to[3]:
            np.testing.assert_allclose(to[3][k].numpy(), np.asarray(jo[3][k]), atol=ATOL)
        js, ts = jo[0], to[0]
