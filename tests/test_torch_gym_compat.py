"""The port's gymnasium wrappers on the CPU: gymnasium's own env checker,
seeding, the degree-based ``frame``, the action check and the registry;
and the single env held to the JAX package's ``GymnasiumEnv`` on the same
reset and transition noise (obs, reward and info within 5e-5, the JAX
package's own kernel tolerance; ``terminated`` and ``truncated`` exactly);
the vector wrappers held to the JAX package's ``VectorGymnasiumEnv`` the
same way, through SAME_STEP auto-resets, on the unfused and the fused
path.

The port draws from Philox and the JAX wrappers from ``jax.random``: the
streams differ, so the two are held on the JAX stream fed to the port's
``*_with_noise`` entries, never by seeding both the same.  The port's
classes are built directly, not through ``gym.make``: one process has one
gymnasium registry, and a worker that ran ``tests/test_gym_compat.py``
holds the JAX package's ids there (the registry tests use a copy of it).
"""

import functools

import gymnasium as gym
import gymnasium.envs.registration as gym_registration
import jax
import numpy as np
import pytest
import torch

import rsoccer_tpu.gym_compat as jgym
import rsoccer_tpu.gym_compat.vector as jvec
from rsoccer_tpu.envs.base import draw_noise as jdraw
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.batch.host import HostEnv, HostVectorEnv
from rsoccer_tpu_torch.gym_compat import ENTRY_POINT, GymnasiumEnv, register_gymnasium
from rsoccer_tpu_torch.gym_compat.vector import VectorGymnasiumEnv
from rsoccer_tpu_torch.registry import registered_ids

torch.set_num_threads(1)

ATOL = 5e-5
REFERENCE_IDS = ["VSS-v0", "SSLStaticDefenders-v0", "SSLDribbling-v0",
                 "SSLContestedPossession-v0", "SSLPassEndurance-v0"]
N_STEPS = 10
STEP_LIMIT = 6  # patched on both sides, so truncation flips inside the window


def _port_noise(noise):
    """A JAX single-env noise dict -> the port's, with a trailing batch of 1."""
    return convert.noise_from_numpy({k: np.asarray(v)[..., None] for k, v in noise.items()}, device="cpu")


@pytest.mark.parametrize("env_id", REFERENCE_IDS)
def test_gymnasium_env_checker(env_id):
    from gymnasium.utils.env_checker import check_env

    env = GymnasiumEnv(env_id, device="cpu")
    check_env(env, skip_render_check=True)
    env.close()


def test_seeding_is_reproducible():
    a, b, c = (GymnasiumEnv("VSS-v0", device="cpu") for _ in range(3))
    oa, _ = a.reset(seed=7)
    ob, _ = b.reset(seed=7)
    oc, _ = c.reset(seed=8)
    np.testing.assert_array_equal(oa, ob)
    assert not np.array_equal(oa, oc)
    for _ in range(5):
        act = np.array([0.3, -0.2], dtype=np.float32)
        ra, rb = a.step(act), b.step(act)
        np.testing.assert_array_equal(ra[0], rb[0])
        assert ra[1:] == rb[1:]
    # a reset without a seed goes on with the stream
    assert not np.array_equal(a.reset()[0], oa)


def test_step_returns_python_types_and_frame_reads_degrees():
    env = GymnasiumEnv("VSS-v0", device="cpu")
    assert env.frame is None
    obs, info = env.reset(seed=0)
    assert obs.shape == (40,) and obs.dtype == np.float32 and info == {}
    obs, reward, terminated, truncated, info = env.step(np.array([0.5, -0.5], dtype=np.float32))
    assert isinstance(reward, float) and type(terminated) is bool and type(truncated) is bool
    assert "goal_score" in info and all(isinstance(v, float) for v in info.values())
    frame = env.frame
    assert len(frame.robots_blue) == 3 and len(frame.robots_yellow) == 3
    for rb in (*frame.robots_blue.values(), *frame.robots_yellow.values()):
        assert 0.0 <= rb.theta < 360.0  # degrees at the API edge
    assert any(rb.theta > 2 * np.pi for rb in frame.robots_blue.values())
    assert frame.robots_blue[0].yellow is False and frame.robots_yellow[0].yellow is True
    assert env.field is env.env.field and (env.n_robots_blue, env.n_robots_yellow) == (3, 3)
    assert env.steps == 1


@pytest.mark.parametrize("action", [np.zeros(3, np.float32), np.zeros((1, 2), np.float32)],
                         ids=["length3", "shape1x2"])
def test_action_shape_check_raises(action):
    env = GymnasiumEnv("VSS-v0", device="cpu")
    env.reset(seed=0)
    with pytest.raises(ValueError, match="does not match action space"):
        env.step(action)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GymnasiumEnv("VSS-v0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HostEnv("SSLStaticDefenders-v0")


@pytest.mark.parametrize("mode", ["rgb_array", None])
def test_render_rgb_array(mode):
    env = GymnasiumEnv("SSLStaticDefenders-v0", render_mode=mode, device="cpu")
    env.reset(seed=0)
    img = env.render()
    assert img.dtype == np.uint8 and img.shape == (670, 970, 3)
    env.close()
    assert env._renderer is None


@pytest.mark.parametrize("env_id", REFERENCE_IDS)
def test_single_env_matches_jax(env_id):
    """10 steps of random actions from the same reset, on the JAX
    wrapper's own noise stream (SSLDribbling-v0 draws none: both sides run
    end to end), with the step limit at STEP_LIMIT on both sides."""
    jenv = jgym.GymnasiumEnv(env_id)
    env = GymnasiumEnv(env_id, device="cpu")
    jenv.env.max_episode_steps = env.env.max_episode_steps = STEP_LIMIT
    noiseless = env_id == "SSLDribbling-v0"
    assert noiseless == (not env.env.reset_noise_spec() and not env.env.transition_noise_spec())
    want, _ = jenv.reset(seed=3)
    if noiseless:
        got, _ = env.reset(seed=3)
    else:
        _, k = jax.random.split(jax.random.PRNGKey(3))
        got, _ = env.host.reset_with_noise(_port_noise(jdraw(k, jenv.env.reset_noise_spec())))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    rng = np.random.default_rng(1)
    truncs = []
    for t in range(N_STEPS):
        act = rng.uniform(-1, 1, env.env.action_size).astype(np.float32)
        if noiseless:
            got = env.step(act)
        else:
            _, k = jax.random.split(jenv._key)
            noise = _port_noise(jdraw(k, jenv.env.transition_noise_spec()))
            got = env.host.step_with_noise(act, noise)
        want = jenv.step(act)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL, err_msg=f"obs, step {t}")
        assert abs(got[1] - want[1]) <= ATOL, (t, got[1], want[1])
        assert got[2:4] == want[2:4], t
        assert sorted(got[4]) == sorted(want[4])
        for k_ in want[4]:
            assert abs(got[4][k_] - want[4][k_]) <= ATOL, (t, k_)
        truncs.append(got[3])
    assert truncs == [t + 1 >= STEP_LIMIT for t in range(N_STEPS)]


def _own_registry(monkeypatch):
    """Point gymnasium at a registry of this test's own: the process's
    registry without the port's ids."""
    ids = set(registered_ids())
    reg = {k: v for k, v in gym.registry.items() if k not in ids}
    monkeypatch.setattr(gym_registration, "registry", reg)
    monkeypatch.setattr(gym, "registry", reg)
    return reg


def test_gym_make_goes_through_the_port(monkeypatch):
    _own_registry(monkeypatch)
    register_gymnasium()
    for env_id in registered_ids():
        assert gym.spec(env_id).entry_point == ENTRY_POINT, env_id
    env = gym.make("VSS-v0", device="cpu")
    assert type(env.unwrapped) is GymnasiumEnv and env.unwrapped.host.device.type == "cpu"
    obs, _ = env.reset(seed=42)
    obs, reward, terminated, truncated, info = env.step(np.array([0.5, -0.5], dtype=np.float32))
    assert obs.shape == (40,) and isinstance(reward, float)
    env.close()


def test_register_gymnasium_keeps_ids_already_registered(monkeypatch):
    """The registry caveat: where the JAX package registered its wrappers
    first, the port's register_gymnasium skips those ids (as the JAX
    package's does), and gym.make builds the JAX env."""
    reg = _own_registry(monkeypatch)
    jgym.register_gymnasium()
    assert gym.spec("VSS-v0").entry_point == "rsoccer_tpu.gym_compat:GymnasiumEnv"
    del reg["SSLDribbling-v0"]
    register_gymnasium()
    assert gym.spec("VSS-v0").entry_point == "rsoccer_tpu.gym_compat:GymnasiumEnv"
    assert gym.spec("SSLDribbling-v0").entry_point == ENTRY_POINT


# ---- the vector wrappers: SAME_STEP auto-reset through step limits of 3
VEC_B = 16
VEC_STEPS = 6
VEC_LIMIT = 3


@functools.lru_cache(maxsize=None)
def jax_vector_run(env_id):
    """The JAX VectorGymnasiumEnv (its XLA path) at VEC_B envs, the step
    limit patched to VEC_LIMIT as in tests/test_gym_compat.py, VEC_STEPS
    steps of random actions: (reset noise, reset obs, [(actions, t_noise,
    r_noise, step result)]), the noise of the wrapper's own stream."""
    venv = jvec.VectorGymnasiumEnv(env_id, VEC_B)
    venv.env.max_episode_steps = VEC_LIMIT
    t_spec, r_spec = venv.benv._t_spec, venv.benv._r_spec
    _, k = jax.random.split(jax.random.PRNGKey(0))
    r0 = jdraw(k, r_spec, batch=VEC_B)
    obs0, _ = venv.reset(seed=0)
    rng = np.random.default_rng(2)
    steps = []
    for _ in range(VEC_STEPS):
        act = rng.uniform(-1, 1, (VEC_B, venv.env.action_size)).astype(np.float32)
        _, k = jax.random.split(venv._key)
        kt, kr = jax.random.split(k)
        tn, rn = jdraw(kt, t_spec, batch=VEC_B), jdraw(kr, r_spec, batch=VEC_B)
        steps.append((act, tn, rn, venv.step(act)))
    return r0, obs0, steps


def _np_noise(noise):
    return convert.noise_from_numpy({k: np.asarray(v) for k, v in noise.items()}, device="cpu")


def assert_vector_step_close(got, want, tag):
    """Two vector steps' (obs, reward, term, trunc, infos): obs, reward,
    info and final_obs within ATOL, the flags and the masks exactly."""
    obs, rew, term, trunc, infos = got
    w_obs, w_rew, w_term, w_trunc, w_infos = want
    np.testing.assert_allclose(obs, w_obs, rtol=0, atol=ATOL, err_msg=f"obs, {tag}")
    np.testing.assert_allclose(rew, w_rew, rtol=0, atol=ATOL, err_msg=f"reward, {tag}")
    np.testing.assert_array_equal(term, w_term, err_msg=tag)
    np.testing.assert_array_equal(trunc, w_trunc, err_msg=tag)
    assert sorted(infos) == sorted(w_infos), tag
    if "_final_obs" not in w_infos:
        return
    for mask in ("_final_obs", "_final_info"):
        np.testing.assert_array_equal(infos[mask], w_infos[mask], err_msg=tag)
    for i in range(len(obs)):
        if not w_infos["_final_obs"][i]:
            assert infos["final_obs"][i] is None and infos["final_info"][i] is None
            continue
        np.testing.assert_allclose(infos["final_obs"][i], w_infos["final_obs"][i], rtol=0, atol=ATOL,
                                   err_msg=f"final_obs {i}, {tag}")
        for k_, v in w_infos["final_info"][i].items():
            assert abs(float(infos["final_info"][i][k_]) - float(v)) <= ATOL, (tag, i, k_)
    for k_ in w_infos:
        if not k_.startswith(("final_", "_final_")):
            np.testing.assert_allclose(infos[k_], np.asarray(w_infos[k_], np.float32), rtol=0, atol=ATOL,
                                       err_msg=f"info {k_}, {tag}")


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("env_id", ["VSS-v0", "SSLStaticDefenders-v0"])
def test_host_vector_env_matches_jax(env_id, fused):
    """HostVectorEnv on the unfused path and on the fused one (the plain
    versions of K1 and K4 here) against the JAX VectorGymnasiumEnv, on its
    noise: every env truncates at steps 3 and 6 and passes through a
    SAME_STEP reset."""
    r0, want_obs0, steps = jax_vector_run(env_id)
    env = HostVectorEnv(env_id, VEC_B, device="cpu", fused=fused)
    env.env.max_episode_steps = VEC_LIMIT
    obs0, info0 = env.reset_with_noise(_np_noise(r0))
    np.testing.assert_allclose(obs0, want_obs0, rtol=0, atol=ATOL)
    assert obs0.shape == (VEC_B, env.env.obs_size) and info0 == {}
    reset_seen = np.zeros(VEC_B, bool)
    for t, (act, tn, rn, want) in enumerate(steps):
        got = env.step_with_noise(act, _np_noise(tn), _np_noise(rn))
        assert_vector_step_close(got, want, f"step {t}")
        if "_final_obs" in got[4]:
            reset_seen |= got[4]["_final_obs"]
    assert reset_seen.all()
    o = env.env.obs_size
    n_info = len(steps[0][3][4])
    assert env.host_bytes == (2 * o + 3 + n_info) * VEC_B * 4  # the one copy per step


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_vector_gymnasium_env_is_host_vector_env(fused):
    """VectorGymnasiumEnv adds spaces and metadata to HostVectorEnv and
    nothing to its steps: the same seed gives the same arrays, bit for
    bit, through SAME_STEP resets."""
    venv = VectorGymnasiumEnv("SSLStaticDefenders-v0", VEC_B, fused=fused, device="cpu")
    host = HostVectorEnv("SSLStaticDefenders-v0", VEC_B, device="cpu", fused=fused)
    assert venv.metadata["autoreset_mode"] is gym.vector.AutoresetMode.SAME_STEP
    assert venv.observation_space.shape == (VEC_B, 24) and venv.action_space.shape == (VEC_B, 5)
    assert venv.single_observation_space.shape == (24,) and venv.num_envs == VEC_B
    venv.env.max_episode_steps = host.env.max_episode_steps = VEC_LIMIT
    obs, _ = venv.reset(seed=5)
    np.testing.assert_array_equal(obs, host.reset(seed=5)[0])
    assert venv.observation_space.contains(obs)
    saw_final = False
    for _ in range(4):
        act = venv.action_space.sample()
        got, want = venv.step(act), host.step(act)
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(a, b)
        assert sorted(got[4]) == sorted(want[4])
        saw_final |= "final_obs" in got[4]
    assert saw_final
    venv.close()


def test_vector_kernel_rng_matches_input_rows():
    """fused_rng="kernel" and "input" draw one Philox stream: on the CPU
    (the plain versions of K1) the same seed gives the same trajectory as
    the unfused path, within ATOL, masks exactly."""
    runs = [HostVectorEnv("VSS-v0", VEC_B, device="cpu", **kw)
            for kw in ({}, {"fused": True}, {"fused": True, "fused_rng": "kernel"})]
    outs = []
    for env in runs:
        env.env.max_episode_steps = VEC_LIMIT
        env.reset(seed=9)
        rng = np.random.default_rng(3)
        outs.append([env.step(rng.uniform(-1, 1, (VEC_B, 2)).astype(np.float32)) for _ in range(VEC_STEPS)])
    for other in outs[1:]:
        for t, (got, want) in enumerate(zip(other, outs[0])):
            assert_vector_step_close(got, want, f"step {t}")


def test_vector_actions_shape_check_raises():
    env = HostVectorEnv("VSS-v0", 4, device="cpu")
    with pytest.raises(RuntimeError, match="before reset"):
        env.step(np.zeros((4, 2), np.float32))
    env.reset(seed=0)
    with pytest.raises(ValueError, match="want"):
        env.step(np.zeros((2, 4), np.float32))
