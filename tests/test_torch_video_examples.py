"""The port's episode video export, ``eval_policy --gif`` and the custom-env
example, on the CPU: a GIF of the expected number of frames (read back
with Pillow), through imageio and through Pillow alone; ``--gif`` without
pygame raises; the port's ``ReachBallEnv`` touches the ball at the step
the JAX package's ``examples/custom_env.py`` does, on every env."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rsoccer_tpu_torch as rt
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.examples import custom_env, eval_policy
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.utils.video import record_episode, save_gif

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gif_frames(path):
    """(frames, size, total ms) of a GIF; the encoder merges a frame equal
    to the one before into it, adding its duration."""
    with Image.open(path) as im:
        total = 0
        for i in range(im.n_frames):
            im.seek(i)
            total += im.info["duration"]
        return im.n_frames, im.size, total


@pytest.mark.parametrize("writer", ["imageio", "pillow"])
def test_record_episode_and_save_gif(tmp_path, monkeypatch, writer):
    if writer == "pillow":
        monkeypatch.setitem(sys.modules, "imageio", None)  # imageio absent
    env = rt.make("VSS-v0")
    frames = record_episode(env, seed=0, max_steps=20, every=2, device="cpu")
    assert len(frames) == 10  # 20 steps of random actions end in no goal
    assert all(f.dtype == np.uint8 and f.shape == (750, 850, 3) for f in frames)
    assert not np.array_equal(frames[0], frames[-1])
    path = save_gif(frames, str(tmp_path / "episode.gif"))
    assert gif_frames(path) == (10, (850, 750), 10 * 50)  # 20 fps


def test_record_episode_stops_at_termination():
    """SSLPassEndurance-v0 under a policy that kicks at once: the episode
    ends (the ball leaves or is received) before the step limit."""
    env = rt.make("SSLPassEndurance-v0")

    def kick(gen, obs):
        return torch.ones((env.action_size, obs.shape[-1]))

    frames = record_episode(env, policy=kick, seed=1, max_steps=400, every=1, device="cpu")
    assert 1 < len(frames) < 400


def test_eval_policy_writes_a_gif(tmp_path, capsys):
    """PassEndurance under a fresh policy: its episode ends (the ball
    stops or leaves) long before the GIF's 600-step cap."""
    path = str(tmp_path / "pe.gif")
    rc = eval_policy.main(["--device", "cpu", "--env-id", "SSLPassEndurance-v0", "--envs", "8",
                           "--steps", "10", "--hidden", "32,32", "--gif", path])
    out = capsys.readouterr().out
    assert rc == 0 and f"wrote {path} (" in out
    n = int(out.split(f"wrote {path} (")[1].split(" frames")[0])
    n_gif, size, ms = gif_frames(path)
    assert 1 <= n < 300 and 1 <= n_gif <= n and size == (970, 670) and ms == n * 50


def test_eval_policy_gif_without_pygame_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pygame", None)  # pygame absent
    with pytest.raises(ImportError):
        eval_policy.main(["--device", "cpu", "--envs", "4", "--steps", "2", "--gif",
                          str(tmp_path / "x.gif")])
    assert not (tmp_path / "x.gif").exists()


def jax_touch_step():
    """The step at which the JAX package's examples/custom_env.py
    ReachBallEnv touches the ball (its __main__ loop)."""
    spec = importlib.util.spec_from_file_location("jax_custom_env", os.path.join(REPO, "examples", "custom_env.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    env = mod.ReachBallEnv()
    state, _ = env.reset(jax.random.PRNGKey(0))
    step = jax.jit(env.step)
    for t in range(300):
        state, obs, r, term, trunc, info = step(state, jnp.asarray([1.0, 1.0]), jax.random.PRNGKey(t))
        if bool(term):
            return t
    raise AssertionError("the JAX example never touched the ball")


def test_custom_env_touches_when_the_jax_example_does(capsys):
    want = jax_touch_step()
    first = custom_env.touch_steps(37, device="cpu")
    assert first.tolist() == [want] * 37
    assert custom_env.main(["--device", "cpu", "--envs", "5"]) == 0
    assert f"5 envs touched the ball at step {want}" in capsys.readouterr().out


def test_custom_env_obs_and_auto_reset():
    """The custom env through the batched env: obs of its own size, a
    reward of 1 on the touch, and the touching env reset to its spawn."""
    env = custom_env.ReachBallEnv()
    benv = BatchedEnv(env, 3, device="cpu")
    key = make_key(0, device="cpu")
    state, obs = benv.reset(key)
    assert obs.shape == (6, 3) and float(obs[0, 0]) == pytest.approx(env.field.half_length - env.field.penalty_length)
    obs0 = obs.clone()
    for _ in range(40):
        state, obs, r, term, trunc, info = benv.step(state, torch.ones((2, 3)), key)
        if bool(term.any()):
            break
    assert term.all() and torch.equal(r, torch.ones(3)) and not trunc.any()
    assert torch.equal(obs, obs0) and torch.equal(state.steps, torch.zeros(3, dtype=torch.int32))
