"""The port's physics calibration (``rsoccer_tpu_torch/tools/calibrate.py``)
against the JAX package's (``tools/calibrate.py``) on one JAX trajectory:
the loss and its six gradients against ``jax.value_and_grad`` of the JAX
tool's loss, the tie case (a robot pinned at a wall, saturated motors),
the recovery of perturbed coefficients, and the float path's forward."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rsoccer_tpu.core import state as jstate
from rsoccer_tpu.core.field import vss_field as j_vss_field
from rsoccer_tpu.physics.config import VSS_PHYSICS as J_PHYS
from rsoccer_tpu.physics.vss import make_vss_step as j_make_step
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.core import state as tstate
from rsoccer_tpu_torch.core.field import vss_field
from rsoccer_tpu_torch.physics import common
from rsoccer_tpu_torch.physics.config import VSS_PHYSICS
from rsoccer_tpu_torch.physics.vss import make_vss_step
from rsoccer_tpu_torch.tools import calibrate as tcal
from tests.test_calibrate import _trajectory
from tools import calibrate as jcal

torch.set_num_threads(1)

DT = 0.025
T = 60
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
FIT_RTOL = 1e-3
F32_EPS = tcal.F32_EPS
FIELD = vss_field(0)
# the true coefficients and two perturbed points
POINTS = {
    "true": {},
    "bad": dict(robot_accel=VSS_PHYSICS.robot_accel * 2.5,
                ball_friction_decel=VSS_PHYSICS.ball_friction_decel * 3.0),
    "mixed": dict(robot_accel=VSS_PHYSICS.robot_accel * 0.7, ball_friction_decel=VSS_PHYSICS.ball_friction_decel * 1.5,
                  robot_alpha=VSS_PHYSICS.robot_alpha * 1.7, lateral_decay=VSS_PHYSICS.lateral_decay * 0.4,
                  rest_ball_wall=0.8, rest_ball_robot=0.3),
}


def _port(states, cmds):
    return (convert.trajectory_from_numpy(jax.tree.map(np.asarray, states), tstate.WorldState, "cpu"),
            convert.trajectory_from_numpy(jax.tree.map(np.asarray, cmds), tstate.VSSCommands, "cpu"))


def _pinned_trajectory(steps: int = T):
    """The tie case, with every contact: robot 0 pinned at the +x wall
    facing along it and robot 1 at the +y wall, both under saturated wheel
    commands (the accel clamp at its bound, the wall clamp holding them on
    the wall); robot 2 driving into robot 3's side (lateral slip); the
    ball rolling into the -x wall and back into robot 4, which stands."""
    field = j_vss_field(0)
    xl = field.half_length - field.rbt_radius
    yl = field.half_width - field.rbt_radius
    step = j_make_step(field, J_PHYS, DT)
    w = jstate.make_world(6)
    w = w._replace(
        ball=w.ball._replace(x=jnp.asarray(-0.5), y=jnp.asarray(-0.45),
                             v_x=jnp.asarray(-1.2), v_y=jnp.asarray(0.1)),
        robots=w.robots._replace(
            x=jnp.asarray([xl, 0.0, -0.1, 0.05, -0.62, 0.4], jnp.float32),
            y=jnp.asarray([0.0, yl, 0.3, 0.3, -0.36, -0.2], jnp.float32),
            theta=jnp.asarray([np.pi / 2, 0.0, 0.0, np.pi / 2, 0.3, 3.0], jnp.float32),
        ),
    )
    step = jax.jit(step)
    big = 10 * field.max_wheel_rad_s
    key = jax.random.PRNGKey(1)
    states, cmds = [w], []
    for _ in range(steps):
        key, k = jax.random.split(key)
        c = jax.random.uniform(k, (2, 6), minval=-30, maxval=30)
        c = c.at[:, :5].set(jnp.asarray([[big, -big, 30.0, 0.0, 0.0], [big, big * 0.5, 30.0, 0.0, 0.0]],
                                        jnp.float32))
        c = jstate.VSSCommands(*c)
        w = step(w, c)
        states.append(w)
        cmds.append(c)
    stack = lambda *ls: jnp.stack(ls)  # noqa: E731
    return jax.tree.map(stack, *states), jax.tree.map(stack, *cmds), xl, yl


@functools.lru_cache(maxsize=None)
def _trajectories():
    """The JAX test's trajectory (T = 60) and the pinned one, each as
    (JAX stack, port trajectory)."""
    states, cmds, _ = _trajectory(T)
    p_states, p_cmds, _, _ = _pinned_trajectory()
    return {"test": ((states, cmds), _port(states, cmds)),
            "pinned": ((p_states, p_cmds), _port(p_states, p_cmds))}


@functools.lru_cache(maxsize=None)
def _jax_loss():
    """The JAX tool's loss (its ``fit_vss_physics.loss_fn``) under
    ``jax.value_and_grad``, jitted once for both trajectories (both T =
    60): (raw log coefficients, states, commands) -> (loss, grads)."""
    field = j_vss_field(0)

    def loss_fn(raw, states, cmds):
        step = j_make_step(field, jcal._to_cfg(raw, J_PHYS), DT)
        cur = jax.tree.map(lambda leaf: leaf[:-1], states)
        nxt = jax.tree.map(lambda leaf: leaf[1:], states)
        errs = jax.vmap(lambda s, c, n: jcal._state_error(step(s, c), n))(cur, cmds, nxt)
        return jnp.mean(errs)

    return jax.jit(jax.value_and_grad(loss_fn))


def _j_raw(cfg):
    """The JAX tool's ``_to_raw``, strongly typed f32 (what its updates
    return), so the jitted loss compiles once."""
    return {k: jnp.asarray(v, jnp.float32) for k, v in jcal._to_raw(cfg).items()}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(traj: str, point: str):
    """The JAX loss and its gradients at ``POINTS[point]``: (loss, {name: grad})."""
    loss, grads = _jax_loss()(_j_raw(dataclasses.replace(J_PHYS, **POINTS[point])),
                              *_trajectories()[traj][0])
    return float(loss), {k: float(v) for k, v in grads.items()}


def _jax_fit(traj: str, init_cfg, n_iters: int):
    """The JAX tool's ``fit_vss_physics`` update loop (optax Adam at its
    lr, the NaN guard, the clip to the log bounds) over the loss compiled
    once in :func:`_jax_loss`.  Returns (fitted {name: value}, losses)."""
    states, cmds = _trajectories()[traj][0]
    tx = optax.adam(0.05)
    raw = _j_raw(init_cfg)
    opt = tx.init(raw)
    bounds = {k: (jnp.log(lo), jnp.log(hi)) for k, (lo, hi) in jcal.TUNABLE_BOUNDS.items()}

    @jax.jit
    def update(raw, opt, grads):
        grads = jax.tree.map(lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads)
        upd, opt = tx.update(grads, opt)
        raw = optax.apply_updates(raw, upd)
        return {k: jnp.clip(v, *bounds[k]) for k, v in raw.items()}, opt

    losses = []
    for _ in range(n_iters):
        loss, grads = _jax_loss()(raw, states, cmds)
        raw, opt = update(raw, opt, grads)
        losses.append(float(loss))
    return {k: float(jnp.exp(v)) for k, v in raw.items()}, losses


@pytest.mark.parametrize("traj", ["test", "pinned"])
@pytest.mark.parametrize("point", list(POINTS))
def test_loss_and_grads_match_jax(traj, point):
    """Loss within rel 1e-5, each gradient within rel 1e-4.  Where the
    exact value is zero the float32 rounding is all there is, and a
    relative bound means nothing: at the true coefficients (the loss and
    its gradients vanish but for rounding: the trajectory comes from the
    float path, the loss from the tensor path, and XLA's and torch's
    transcendentals differ in the last bit), and for a gradient below one
    float32 ulp of the largest (a coefficient at its true value, or one the
    trajectory does not observe).  There both packages must sit below that
    ulp, of the loss and the gradients at the fit's start ("bad") for the
    true coefficients."""
    want_loss, want = _jax_value_and_grad(traj, point)
    t_cfg = dataclasses.replace(VSS_PHYSICS, **POINTS[point])
    loss, got = tcal.value_and_grad(*_trajectories()[traj][1], FIELD, DT, t_cfg, device="cpu")
    ref_loss, ref = _jax_value_and_grad(traj, "bad") if point == "true" else (want_loss, want)
    scale = max(abs(v) for v in ref.values())
    if point == "true":
        assert max(float(loss), want_loss) < F32_EPS * ref_loss, (float(loss), want_loss)
    else:
        np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    bad = tcal.grad_mismatches(got, want, GRAD_RTOL, scale=scale)
    assert not bad, bad
    if traj == "pinned" and point == "mixed":  # the scene observes every coefficient
        assert all(abs(want[k]) >= F32_EPS * scale for k in tcal.TUNABLE), want


def test_pinned_scene_holds_robots_on_the_walls():
    """The tie case: the wall clamp holds robots 0 and 1 exactly on their
    bounds at every step."""
    (states, _), _ = _trajectories()["pinned"]
    field = j_vss_field(0)
    np.testing.assert_array_equal(np.asarray(states.robots.x[:, 0]),
                                  np.float32(field.half_length - field.rbt_radius))
    np.testing.assert_array_equal(np.asarray(states.robots.y[:, 1]),
                                  np.float32(field.half_width - field.rbt_radius))


@pytest.mark.parametrize("x", [-1.0, -0.5, 1.0, 2.0])
def test_clip_tie_gradients_match_jax(x):
    """``common.clip`` / ``common.maximum`` pass gradient as ``jnp.clip`` /
    ``jnp.maximum`` do, ties (x on a bound) included, to the input and to
    tensor bounds."""
    def j_fn(v, a):
        return jnp.clip(v, -a, 1.0) + 3.0 * jnp.maximum(v, a - 1.5)

    def t_fn(v, a):
        return common.clip(v, -a, 1.0) + 3.0 * common.maximum(v, a - 1.5)

    want = jax.grad(j_fn, argnums=(0, 1))(jnp.float32(x), jnp.float32(1.0))
    v = torch.tensor(x, requires_grad=True)
    a = torch.tensor(1.0, requires_grad=True)
    t_fn(v, a).backward()
    np.testing.assert_array_equal([v.grad.item(), a.grad.item()], [float(w) for w in want])
    assert float(t_fn(torch.tensor(x), 1.0)) == float(j_fn(jnp.float32(x), 1.0))


def test_fit_recovers_coefficients_like_jax():
    """The JAX test's recovery (200 iterations from its perturbed start,
    its bounds), and the fitted coefficients within rel 1e-3 of the JAX
    tool's."""
    (j_states, j_cmds), (states, cmds) = _trajectories()["test"]
    bad = dataclasses.replace(VSS_PHYSICS, **POINTS["bad"])
    fitted, losses = tcal.fit_vss_physics(states, cmds, FIELD, DT, init_cfg=bad, n_iters=200, device="cpu")
    assert losses[-1] < losses[0] * 1e-3
    assert abs(fitted.robot_accel - VSS_PHYSICS.robot_accel) < 0.3
    assert abs(fitted.ball_friction_decel - VSS_PHYSICS.ball_friction_decel) < 0.1
    j_fitted, j_losses = _jax_fit("test", dataclasses.replace(J_PHYS, **POINTS["bad"]), 200)
    np.testing.assert_allclose(losses[0], j_losses[0], rtol=LOSS_RTOL)
    for k in tcal.TUNABLE:
        np.testing.assert_allclose(getattr(fitted, k), j_fitted[k], rtol=FIT_RTOL, err_msg=k)


def test_gradients_finite_through_resting_ball():
    """A world with the ball exactly at rest yields finite gradients."""
    def loss(decel):
        cfg = dataclasses.replace(VSS_PHYSICS, ball_friction_decel=decel)
        w = tstate.make_world(2, device="cpu")
        w2 = make_vss_step(FIELD, cfg, DT)(w, tstate.VSSCommands(torch.zeros(2, 1), torch.zeros(2, 1)))
        return (w2.ball.x ** 2 + w2.ball.v_x ** 2).sum()

    decel = torch.tensor(0.6, requires_grad=True)
    (g,) = torch.autograd.grad(loss(decel), decel)
    assert torch.isfinite(g)


@pytest.mark.parametrize("traj", ["test", "pinned"])
def test_tensor_coefficients_forward_matches_float_path(traj):
    """Tensor coefficients equal to the float ones give the float path's
    step within 1e-6 (the constants fold in f32, not in double)."""
    _, (states, cmds) = _trajectories()[traj]
    cur = tstate.tree_map(lambda t: t[..., :-1], states)
    want = make_vss_step(FIELD, VSS_PHYSICS, DT)(cur, cmds)
    t_cfg = dataclasses.replace(VSS_PHYSICS, **{k: torch.tensor(getattr(VSS_PHYSICS, k))
                                                 for k in tcal.TUNABLE})
    got = make_vss_step(FIELD, t_cfg, DT)(cur, cmds)
    for g, w in zip(tcal._leaves(got), tcal._leaves(want)):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=0, atol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_fit_default_device_raises_without_card():
    _, (states, cmds) = _trajectories()["test"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcal.fit_vss_physics(states, cmds, FIELD, DT, n_iters=1)
