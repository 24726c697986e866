"""Differentiable calibration of the VSS physics coefficients.

The counterpart of the JAX package's ``tools/calibrate.py``.  Given a
trajectory (robot logs, or golden rSim runs), it fits the ``PhysicsConfig``
coefficients of ``TUNABLE_BOUNDS`` by gradient descent THROUGH the plain
VSS step (``physics/vss.make_vss_step``, whose coefficients may be 0-d
tensors): autograd flows through the motor clamp, the lateral decay, ball
friction and (sub-gradient) the contact branches.  The loss is one-step
teacher-forced prediction error: each transition starts from the logged
state, and the squared error of each state leaf is meaned within the leaf
and summed over leaves, then meaned over transitions.

Usage (library):

    from rsoccer_tpu_torch.tools.calibrate import fit_vss_physics
    fitted_cfg, losses = fit_vss_physics(states, commands, field, dt)

where ``states`` is a ``WorldState`` whose LAST axis is time (T+1; ball
leaves ``(T+1,)``, robot leaves ``(N, T+1)``) and ``commands`` a
``VSSCommands`` whose last axis is the T steps: the transitions are the
step's batch axis.  Leaves may carry env axes before time (ball ``(E,
T+1)``, robots ``(N, E, T+1)``): then each env's T transitions count.
``convert.trajectory_from_numpy`` carries a JAX stack (time first) in.

As a self-test that recovers known coefficients from a synthetic
trajectory (6 robots, T = 80, 300 iterations), on the card unless
``--device cpu``:

    python -m rsoccer_tpu_torch.tools.calibrate [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from rsoccer_tpu_torch.core.field import FieldParams, vss_field
from rsoccer_tpu_torch.core.state import VSSCommands, make_world, tree_map
from rsoccer_tpu_torch.models.networks import check_device
from rsoccer_tpu_torch.physics.config import VSS_PHYSICS, PhysicsConfig
from rsoccer_tpu_torch.physics.vss import make_vss_step

# coefficients the fit adjusts, with physical bounds (restitutions must stay
# below 1 or the dynamics are energy-gaining and the loss explodes)
TUNABLE_BOUNDS = {
    "robot_accel": (1e-2, 1e3),
    "robot_alpha": (1e-1, 1e4),
    "lateral_decay": (1e-1, 1e3),
    "ball_friction_decel": (1e-3, 1e2),
    "rest_ball_wall": (1e-2, 0.99),
    "rest_ball_robot": (1e-2, 0.99),
}
TUNABLE = tuple(TUNABLE_BOUNDS)
DT = 0.025
F32_EPS = float(torch.finfo(torch.float32).eps)


def _log32(v, device) -> torch.Tensor:
    return torch.log(torch.tensor(float(v), dtype=torch.float32, device=device))


def _to_raw(cfg: PhysicsConfig, device) -> dict:
    """Log-space parameterisation: positive-constrained and well-conditioned
    across the 0.1..200 coefficient range.  Leaves require grad."""
    return {k: _log32(getattr(cfg, k), device).requires_grad_() for k in TUNABLE}


def _to_cfg(raw: dict, base: PhysicsConfig) -> PhysicsConfig:
    return dataclasses.replace(base, **{k: torch.exp(v) for k, v in raw.items()})


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _state_error(pred, target) -> torch.Tensor:
    """Per transition: each leaf's squared error meaned within the leaf
    (bool leaves cast), summed over leaves.  Shape ``(B,)``."""
    err = 0.0
    for a, b in zip(_leaves(pred), _leaves(target)):
        d = a.to(torch.float32) - b.to(torch.float32)
        err = err + (d * d).reshape(-1, d.shape[-1]).mean(0)
    return err


def _loss(raw, cur, commands, nxt, field: FieldParams, dt: float, base: PhysicsConfig):
    step = make_vss_step(field, _to_cfg(raw, base), dt)
    return _state_error(step(cur, commands), nxt).mean()


def _transitions(states, commands, device):
    """(cur, commands, nxt) on ``device``, the trailing batch axes (envs,
    if any, and time) flattened into the step's one batch axis."""
    k = states.ball.x.dim()

    def flat(t):
        t = t.to(device)
        return t.reshape(*t.shape[: t.dim() - k], -1)

    cur = tree_map(lambda t: flat(t[..., :-1]), states)
    nxt = tree_map(lambda t: flat(t[..., 1:]), states)
    return cur, tree_map(flat, commands), nxt


def value_and_grad(states, commands, field: FieldParams, dt: float, cfg: PhysicsConfig,
                   device="cuda"):
    """The fit's loss at ``cfg`` and its gradient with respect to the log
    coefficients: ``(loss, {name: grad})``, 0-d tensors on ``device``."""
    device = check_device(device)
    cur, commands, nxt = _transitions(states, commands, device)
    raw = _to_raw(cfg, device)
    loss = _loss(raw, cur, commands, nxt, field, dt, cfg)
    grads = torch.autograd.grad(loss, [raw[k] for k in TUNABLE])
    return loss.detach(), dict(zip(TUNABLE, grads))


def grad_mismatches(got: dict, want: dict, rtol: float, scale: float | None = None) -> dict:
    """The coefficients whose gradient in ``got`` is not within ``rtol`` of
    ``want``'s, relative: ``{name: (got, want)}``.  A gradient of ``want``
    below one float32 ulp of ``scale`` (default: ``want``'s largest) is
    rounding noise, whose relative error means nothing: there ``got`` must
    only stay below that ulp too."""
    floor = F32_EPS * (max(abs(float(v)) for v in want.values()) if scale is None else scale)
    bad = {}
    for k in want:
        g, w = float(got[k]), float(want[k])
        ok = abs(g) < floor if abs(w) < floor else abs(g - w) <= rtol * abs(w)
        if not ok:
            bad[k] = (g, w)
    return bad


def fit_vss_physics(
    states,
    commands,
    field: FieldParams,
    dt: float,
    init_cfg: PhysicsConfig = VSS_PHYSICS,
    n_iters: int = 300,
    lr: float = 0.05,
    device="cuda",
):
    """One-step teacher-forced fit by Adam (optax's defaults) in log space.
    Returns (fitted PhysicsConfig with float coefficients, losses: one per
    iteration, before its update).  Runs on ``device``, the card unless
    the caller asks for the CPU."""
    device = check_device(device)
    cur, commands, nxt = _transitions(states, commands, device)
    raw = _to_raw(init_cfg, device)
    params = [raw[k] for k in TUNABLE]
    opt = torch.optim.Adam(params, lr=lr, eps=1e-8)
    bounds = [(_log32(lo, device), _log32(hi, device)) for lo, hi in TUNABLE_BOUNDS.values()]
    losses = []
    for _ in range(n_iters):
        loss = _loss(raw, cur, commands, nxt, field, dt, init_cfg)
        grads = torch.autograd.grad(loss, params)
        # NaN-guard: skip a step whose gradient is non-finite (collision
        # sub-gradients can spike at contact boundaries)
        for p, g in zip(params, grads):
            p.grad = torch.where(torch.isfinite(g), g, 0.0)
        opt.step()
        with torch.no_grad():  # per-coefficient physical windows
            for p, (lo, hi) in zip(params, bounds):
                p.copy_(torch.minimum(torch.maximum(p, lo), hi))
        losses.append(loss.detach())
    losses = torch.stack(losses).tolist() if losses else []
    fitted = {k: float(torch.exp(raw[k].detach())) for k in TUNABLE}
    return dataclasses.replace(init_cfg, **fitted), losses


def synthetic_trajectory(T: int = 80, device="cuda", seed: int = 0):
    """An informative trajectory of the true coefficients: 6 robots
    driving under uniform wheel commands in [-30, 30] rad/s, the ball
    rolling.  Returns (states (time last, T+1), commands (T), field)."""
    device = check_device(device)
    field = vss_field(0)
    step = make_vss_step(field, VSS_PHYSICS, DT)
    w = make_world(6, device=device)
    lin = lambda a, b: torch.linspace(a, b, 6, device=device)[:, None]  # noqa: E731
    w = w._replace(
        ball=w.ball._replace(
            x=torch.full((1,), 0.1, device=device), y=torch.full((1,), 0.1, device=device),
            v_x=torch.full((1,), 0.8, device=device), v_y=torch.full((1,), -0.4, device=device),
        ),
        robots=w.robots._replace(x=lin(-0.6, 0.4), y=lin(-0.4, 0.4), theta=lin(0.0, 3.0)),
    )
    gen = torch.Generator().manual_seed(seed)
    cmds = (torch.rand((T, 2, 6, 1), generator=gen) * 60.0 - 30.0).to(device)
    states = [w]
    for t in range(T):
        w = step(w, VSSCommands(cmds[t, 0], cmds[t, 1]))
        states.append(w)
    states = tree_map(lambda *ls: torch.cat(ls, dim=-1), *states)
    commands = VSSCommands(cmds[:, 0, :, 0].T.contiguous(), cmds[:, 1, :, 0].T.contiguous())
    return states, commands, field


def perturbed(cfg: PhysicsConfig = VSS_PHYSICS) -> PhysicsConfig:
    """The self-test's badly perturbed start."""
    return dataclasses.replace(
        cfg,
        robot_accel=cfg.robot_accel * 2.5,
        lateral_decay=cfg.lateral_decay * 0.4,
        ball_friction_decel=cfg.ball_friction_decel * 3.0,
    )


def selftest(device="cuda", n_iters: int = 300):
    """Recover perturbed coefficients from a synthetic trajectory.
    Returns (true cfg, fitted cfg, losses)."""
    states, cmds, field = synthetic_trajectory(device=device)
    bad = perturbed()
    fitted, losses = fit_vss_physics(states, cmds, field, DT, init_cfg=bad, n_iters=n_iters,
                                     device=device)
    return VSS_PHYSICS, fitted, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=300)
    args = ap.parse_args(argv)
    true_cfg, fitted, losses = selftest(args.device, args.iters)
    bad = perturbed()
    print(f"loss: {losses[0]:.3e} -> {losses[-1]:.3e}")
    for k in TUNABLE:
        print(f"  {k:22s} true {getattr(true_cfg, k):8.3f}  "
              f"start {getattr(bad, k):8.3f}  fitted {getattr(fitted, k):8.3f}")
    print(json.dumps({"device": args.device, "iters": args.iters, "loss_first": losses[0],
                      "loss_last": losses[-1], "fitted": {k: getattr(fitted, k) for k in TUNABLE}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
