"""The port's host-side views held to the JAX package's: the copied
``Frame`` classes, palette, render geometry and ``NearestNeighbors``; the
frames built from equal states (equal field by field, to the bit); and the
renderer's pixels on those frames (equal, both leagues).

The states come from the port's batched env on the CPU after a few steps
(velocities and wheel speeds set; on DR the ``infrared`` flag) and
go to the JAX package as the same numbers (``convert.state_to_numpy``, then
``jnp.asarray``)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu_torch as rt
from rsoccer_tpu.core import frame as jframe
from rsoccer_tpu.render import colors as jcolors
from rsoccer_tpu.render import renderer as jrenderer
from rsoccer_tpu.utils import neighbors as jneighbors
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.core import frame as tframe
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.render import colors as tcolors
from rsoccer_tpu_torch.render import renderer as trenderer
from rsoccer_tpu_torch.utils import neighbors as tneighbors

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
CONFIGS = {
    "vss_3v3": ("VSS-v0", {}),
    "vss_5v5": ("VSS-v0", dict(field_type=1, n_robots_blue=5, n_robots_yellow=5)),
    "sd": ("SSLStaticDefenders-v0", {}),
    "dr": ("SSLDribbling-v0", {}),
}


@pytest.fixture(scope="module")
def worlds():
    """config -> (port env, port batch-last world, the same world as JAX
    arrays) after 4 steps of random actions; DR after one step of zero
    actions, which leaves the ball on the attacker's face (``infrared``
    set; the unfused reset state has it False)."""
    out = {}
    for name, (env_id, kw) in CONFIGS.items():
        benv = rt.make_vec(env_id, B, device="cpu", **kw)
        key = make_key(3, device="cpu")
        state, _ = benv.reset(key)
        gen = torch.Generator().manual_seed(4)
        for _ in range(1 if name == "dr" else 4):
            act = torch.rand((benv.action_size, B), generator=gen) * 2 - 1
            if name == "dr":
                act = torch.zeros_like(act)
            state, *_ = benv.step(state, act, key)
        np_world = convert.state_to_numpy(state.world)
        out[name] = (benv.env, state.world, jax.tree.map(jnp.asarray, np_world))
    return out


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("cls", ["Ball", "Robot", "Frame"])
def test_frame_classes_equal_jax(cls):
    assert _fields(getattr(tframe, cls)) == _fields(getattr(jframe, cls))
    assert tframe.Frame() == tframe.Frame() and dataclasses.asdict(tframe.Frame()) == \
        dataclasses.asdict(jframe.Frame())


def test_colors_equal_jax():
    assert tcolors.COLORS == jcolors.COLORS
    assert tcolors.VSS_TAG_COLORS == jcolors.VSS_TAG_COLORS
    assert tcolors._SSL_TAG_BITS == jcolors._SSL_TAG_BITS
    assert [tcolors.ssl_tag_colors(i) for i in range(20)] == [jcolors.ssl_tag_colors(i) for i in range(20)]


@pytest.mark.parametrize("geom", ["VSS_GEOMETRY", "SSL_GEOMETRY"])
def test_render_geometry_equal_jax(geom):
    t, j = getattr(trenderer, geom), getattr(jrenderer, geom)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.screen_size == j.screen_size and t.center == j.center
    assert trenderer.BALL_RADIUS == jrenderer.BALL_RADIUS
    assert trenderer.Renderer.fps == jrenderer.Renderer.fps


@pytest.mark.parametrize("config", list(CONFIGS))
def test_frames_equal_jax(worlds, config):
    """frame_from_batched of every env and frame_from_world of a batch of
    1 give the JAX package's frames, every field equal."""
    env, world, jworld = worlds[config]
    nb, ny = env.n_blue, env.n_yellow
    for i in range(B):
        want = dataclasses.asdict(jframe.frame_from_batched(jworld, i, nb, ny))
        assert dataclasses.asdict(tframe.frame_from_batched(world, i, nb, ny)) == want, i
        single = jax.tree.map(lambda leaf: leaf[..., i], jworld)
        assert dataclasses.asdict(jframe.frame_from_world(single, nb, ny)) == want
        one = type(world)(*(type(part)(*(leaf[..., i:i + 1] for leaf in part)) for part in world))
        assert dataclasses.asdict(tframe.frame_from_world(one, nb, ny)) == want, i
    fr = tframe.frame_from_batched(world, 0, nb, ny)
    assert len(fr.robots_blue) == nb and len(fr.robots_yellow) == ny
    assert all(0.0 <= r.theta < 360.0 for r in (*fr.robots_blue.values(), *fr.robots_yellow.values()))
    if config == "dr":  # the ball on the attacker's face
        assert fr.robots_blue[0].infrared
    else:
        assert any(r.v_theta != 0.0 for r in fr.robots_blue.values())


def test_frame_from_world_refuses_a_batch(worlds):
    env, world, _ = worlds["vss_3v3"]
    with pytest.raises(ValueError, match="batch of 1"):
        tframe.frame_from_world(world, env.n_blue, env.n_yellow)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_renderer_pixels_equal_jax(worlds, config):
    """rgb_array frames of the port's and the JAX package's Renderer on
    the same states: every pixel equal."""
    env, world, jworld = worlds[config]
    nb, ny = env.n_blue, env.n_yellow
    tr, jr = trenderer.Renderer(env.league), jrenderer.Renderer(env.league)
    try:
        for i in (0, 3, B - 1):
            got = tr.render_frame(tframe.frame_from_batched(world, i, nb, ny))
            want = jr.render_frame(jframe.frame_from_batched(jworld, i, nb, ny))
            assert got.dtype == np.uint8 and got.shape == want.shape == (*tr.window_size[::-1], 3)
            np.testing.assert_array_equal(got, want)
    finally:
        tr.close()
        jr.close()


def test_nearest_neighbors_equal_jax():
    rng = np.random.default_rng(0)
    t, j = tneighbors.NearestNeighbors(), jneighbors.NearestNeighbors()
    with pytest.raises(ValueError):
        t.get_nearest((0.0, 0.0))
    for p in rng.uniform(-2, 2, size=(13, 2)):
        t.insert(p)
        j.insert(p)
        for q in rng.uniform(-2, 2, size=(5, 2)):
            assert t.get_nearest(q) == j.get_nearest(q)
    assert tneighbors.KDTree is tneighbors.NearestNeighbors


def test_host_modules_import_without_gymnasium_pygame_or_jax():
    """batch/host.py, core/frame.py and utils/neighbors.py import where
    gymnasium and pygame are not installed (both blocked here), and load
    no jax."""
    code = (
        "import sys; sys.modules['gymnasium'] = None; sys.modules['pygame'] = None; "
        "import rsoccer_tpu_torch.batch.host, rsoccer_tpu_torch.core.frame, "
        "rsoccer_tpu_torch.utils.neighbors; "
        "assert 'jax' not in sys.modules and 'rsoccer_tpu' not in sys.modules; print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_gym_and_render_modules_import_no_jax():
    code = (
        "import sys, rsoccer_tpu_torch.gym_compat, rsoccer_tpu_torch.gym_compat.vector, "
        "rsoccer_tpu_torch.render.renderer, rsoccer_tpu_torch.utils.video, "
        "rsoccer_tpu_torch.examples.custom_env, rsoccer_tpu_torch.examples.eval_policy; "
        "assert 'jax' not in sys.modules and 'rsoccer_tpu' not in sys.modules; print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
