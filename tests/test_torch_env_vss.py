"""The port's VSS-v0 env functions vs the JAX package's, fed the same
noise: reset, observe, step_with_noise(_final) through auto-resets, and
the golden VSS-v0 trajectory."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu.envs.base import draw_noise as j_draw_noise
from rsoccer_tpu_torch import convert

torch.set_num_threads(1)

B = 16
ATOL = 5e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "golden", "fixtures.npz")


def np_noise(rng, spec, b):
    out = {}
    for name, (shape, kind) in spec.items():
        draw = rng.uniform(size=shape + (b,)) if kind == "uniform" else rng.normal(size=shape + (b,))
        out[name] = draw.astype(np.float32)
    return out


def pair(max_steps=None):
    jenv, tenv = rsoccer_tpu.make("VSS-v0"), rsoccer_tpu_torch.make("VSS-v0")
    if max_steps is not None:
        jenv.max_episode_steps = tenv.max_episode_steps = max_steps
    return jenv, tenv


def vm(fn):
    return jax.vmap(fn, in_axes=-1, out_axes=-1)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_states_close(port_state, jax_state, atol=ATOL, tag=""):
    got = jax.tree.leaves(convert.state_to_numpy(port_state))
    want = jax.tree.leaves(to_np(jax_state))
    assert len(got) == len(want)
    theta_idx = 8  # ball 6 leaves, then robots x, y, theta
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (tag, i)
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} leaf {i}")
        else:
            if i == theta_idx:  # same angle across the +-pi wrap
                g = np.remainder(g - w + np.pi, 2 * np.pi) - np.pi
                w = np.zeros_like(w)
            np.testing.assert_allclose(g, w, atol=atol, err_msg=f"{tag} leaf {i}")


def test_reset_state_and_observe_match_jax():
    jenv, tenv = pair()
    noise = np_noise(np.random.default_rng(0), jenv.reset_noise_spec(), B)
    js = vm(jenv.reset_state)({k: jnp.asarray(v) for k, v in noise.items()})
    ts = tenv.reset_state(convert.noise_from_numpy(noise, device="cpu"))
    assert_states_close(ts, js, atol=0)
    np.testing.assert_allclose(
        tenv.observe(ts).numpy(), np.asarray(vm(jenv.observe)(js)), atol=1e-6
    )


@pytest.mark.parametrize("final", [False, True], ids=["step", "step_final"])
@pytest.mark.parametrize("max_steps", [None, 3], ids=["limit1200", "limit3"])
def test_step_with_noise_matches_jax(final, max_steps):
    jenv, tenv = pair(max_steps)
    rng = np.random.default_rng(7 if max_steps else 8)
    r0 = np_noise(rng, jenv.reset_noise_spec(), B)
    js = vm(jenv.reset_state)({k: jnp.asarray(v) for k, v in r0.items()})
    ts = tenv.reset_state(convert.noise_from_numpy(r0, device="cpu"))
    j_fn = vm(jenv.step_with_noise_final if final else jenv.step_with_noise)
    t_fn = tenv.step_with_noise_final if final else tenv.step_with_noise
    saw_done = False
    for t in range(8):
        act = rng.uniform(-1, 1, (2, B)).astype(np.float32)
        tn = np_noise(rng, jenv.transition_noise_spec(), B)
        rn = np_noise(rng, jenv.reset_noise_spec(), B)
        jo = j_fn(js, jnp.asarray(act), *({k: jnp.asarray(v) for k, v in d.items()} for d in (tn, rn)))
        to = t_fn(ts, torch.from_numpy(act), convert.noise_from_numpy(tn, device="cpu"), convert.noise_from_numpy(rn, device="cpu"))
        js, ts = jo[0], to[0]
        tag = f"step {t}"
        assert_states_close(ts, js, tag=tag)
        n_obs = 2 if final else 1
        for k in range(1, 1 + n_obs):  # obs (and final obs)
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
    if max_steps is not None:
        assert saw_done


def test_golden_vss_trajectory():
    """Replay tests/golden/fixtures.npz for VSS-v0 through the port: the
    noise of each step is the JAX package's draw_noise from the keys of
    tests/test_golden.py, converted to numpy."""
    from tests.golden.record import N_STEPS, scripted_action

    fx = np.load(FIXTURES)
    want_obs, want_rew, want_done = fx["VSS_v0_obs"], fx["VSS_v0_rew"], fx["VSS_v0_done"]
    jenv, tenv = pair()

    def single(noise):  # unbatched JAX draw -> batch of one
        return convert.noise_from_numpy({k: np.asarray(v)[..., None] for k, v in noise.items()}, device="cpu")

    state = tenv.reset_state(single(j_draw_noise(jax.random.PRNGKey(123), jenv.reset_noise_spec())))
    np.testing.assert_allclose(tenv.observe(state)[:, 0].numpy(), want_obs[0], atol=1e-5)
    for t in range(N_STEPS):
        a = torch.from_numpy(np.asarray(scripted_action("VSS-v0", t, 2)))[:, None]
        kt, kr = jax.random.split(jax.random.PRNGKey(1000 + t))
        state, obs, r, term, trunc, _ = tenv.step_with_noise(
            state, a,
            single(j_draw_noise(kt, jenv.transition_noise_spec())),
            single(j_draw_noise(kr, jenv.reset_noise_spec())),
        )
        np.testing.assert_allclose(obs[:, 0].numpy(), want_obs[t + 1], atol=1e-4,
                                   err_msg=f"obs diverged at step {t}")
        np.testing.assert_allclose(float(r[0]), want_rew[t], atol=1e-4,
                                   err_msg=f"reward diverged at step {t}")
        assert bool(term[0] | trunc[0]) == bool(want_done[t])
