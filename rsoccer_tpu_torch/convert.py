"""State carried across between the JAX package and the port.

``state_from_numpy`` takes one of the JAX package's batched env states
(``VSSState``, ``SDState``, ``CPState``) with numpy leaves
(``jax.tree.map(np.asarray, s)``) — or any object with the same attribute
tree — and builds the port's state of the class it is given on ``device``
(the card unless the caller asks for the CPU).  ``state_to_numpy`` goes
back: the port's state with numpy leaves, whose fields flatten in the JAX
package's leaf order.  The same pair exists for noise dicts, and for
trajectories (``trajectory_from_numpy``, ``trajectory_to_numpy``): a JAX
stack of single-env states or commands, time first (``(T+1, N)``,
``(T+1,)``, ``v_wheel`` ``(T+1, N, 4)``), is the port's state with time as
its batch axis (``(N, T+1)``, ``(T+1,)``, ``v_wheel`` ``(N, 4, T+1)``).

The PPO policy crosses as the JAX package's ``{params, obs_norm}``
checkpoint tree (``examples/train_ppo_vss.py``): ``ppo_to_numpy`` builds
that tree from an :class:`~rsoccer_tpu_torch.models.networks.ActorCritic`
and an :class:`~rsoccer_tpu_torch.models.ppo.ObsNorm`, ``ppo_from_leaves``
and ``load_ppo_checkpoint`` go back from its positional leaves, with no
jax.  The leaves, in the JAX leaf order (dict keys sorted; the flax
``Dense`` kernels stored ``(in, out)``, transposed into ``Linear.weight``)::

    0, 1, 2   obs_norm.mean (O,), .var (O,), .count ()
    3, 4      actor_0 bias, kernel      (hidden towers: bias, kernel
    5, 6      actor_1 bias, kernel       per layer, actor_0 .. actor_{L-1})
    7, 8      actor_out bias (A,), kernel
    9 .. 12   critic_0, critic_1
    13, 14    critic_out bias (1,), kernel
    15        log_std (A,)

(for the shipped towers of L = 2 hidden layers; ``hidden``, ``O`` and
``A`` come from the shapes).

A SAC actor crosses as the JAX package's ``actor_params`` tree (what
``examples/train_sac_vss.py --save`` writes, e.g.
``artifacts/sac_sd_best2.ckpt.npz``): ``sac_actor_to_numpy`` builds it
from a :class:`~rsoccer_tpu_torch.models.sac.SquashedGaussianActor`,
``sac_actor_from_leaves`` and ``load_sac_checkpoint`` go back, with no
jax.  Its leaves, in the JAX leaf order::

    0, 1      fc0 bias (h0,), kernel (O, h0)
    2, 3      fc1 bias (h1,), kernel (h0, h1)      (fc0 .. fc{L-1})
    4, 5      log_std bias (A,), kernel (h1, A)
    6, 7      mean bias (A,), kernel (h1, A)

The twin critics cross the same way with a leading axis of 2 on every leaf
(``fc0 .. fc{L-1}``, then ``q`` with one output), as the JAX package's
stacked ``qs_params``: ``sac_critics_to_numpy``,
``sac_critics_from_leaves``.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from rsoccer_tpu_torch.core.state import tree_map


def _is_namedtuple_type(t) -> bool:
    return isinstance(t, type) and issubclass(t, tuple) and hasattr(t, "_fields")


def _from(obj, cls, device):
    hints = typing.get_type_hints(cls)
    fields = []
    for name in cls._fields:
        sub = getattr(obj, name)
        if _is_namedtuple_type(hints.get(name)):
            fields.append(_from(sub, hints[name], device))
        else:
            fields.append(torch.tensor(np.asarray(sub), device=device))
    return cls(*fields)


def state_from_numpy(tree, cls, device="cuda"):
    """JAX-package env state (numpy leaves) -> the port's ``cls``
    (``VSSState``, ``SDState`` or ``CPState``)."""
    return _from(tree, cls, device)


def state_to_numpy(state):
    """Port env state -> the same NamedTuple with numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)


def trajectory_from_numpy(tree, cls, device="cuda"):
    """A JAX time-first stack (numpy leaves) of ``WorldState``s or
    ``VSSCommands`` -> the port's ``cls`` with time as the last axis."""
    return tree_map(lambda t: t.movedim(0, -1).contiguous(), state_from_numpy(tree, cls, device))


def trajectory_to_numpy(traj):
    """The port's time-last trajectory -> the same NamedTuple with numpy
    leaves stacked time first, as the JAX package stacks them."""
    return tree_map(lambda a: np.ascontiguousarray(np.moveaxis(a, -1, 0)), state_to_numpy(traj))


def noise_from_numpy(noise: dict, device="cuda") -> dict:
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in noise.items()}


def noise_to_numpy(noise: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in noise.items()}


def _ppo_names(n_hidden: int) -> list[str]:
    """The flax ActorCritic's parameter names in the JAX leaf order."""
    return sorted(
        [f"actor_{i}" for i in range(n_hidden)] + ["actor_out"]
        + [f"critic_{i}" for i in range(n_hidden)] + ["critic_out", "log_std"]
    )


def _ppo_layer(net, name: str):
    tower, _, idx = name.partition("_")
    return getattr(net, name) if idx == "out" else getattr(net, tower)[int(idx)]


def ppo_to_numpy(net, obs_norm) -> dict:
    """ActorCritic + ObsNorm -> the JAX package's ``{params, obs_norm}``
    checkpoint tree with numpy leaves (flax names, kernels ``(in, out)``)."""
    from rsoccer_tpu_torch.models.ppo import ObsNorm

    def np_(t):
        return t.detach().cpu().numpy()

    params = {}
    for name in _ppo_names(len(net.hidden)):
        if name == "log_std":
            params[name] = np_(net.log_std)
        else:
            layer = _ppo_layer(net, name)
            params[name] = {"bias": np_(layer.bias), "kernel": np_(layer.weight).T.copy()}
    return {"obs_norm": ObsNorm(*(np_(t) for t in obs_norm)), "params": {"params": params}}


def ppo_from_leaves(leaves, device="cuda", compute_dtype=torch.bfloat16):
    """A PPO checkpoint's positional leaves (numpy, the table above) ->
    (ActorCritic, ObsNorm) on ``device``.  Raises, naming the leaf, where
    the layout differs."""
    from rsoccer_tpu_torch.models.networks import ActorCritic, check_device
    from rsoccer_tpu_torch.models.ppo import ObsNorm

    device = check_device(device)
    leaves = [np.array(a) for a in leaves]  # writable copies
    n = len(leaves)
    if n < 8 or (n - 8) % 4:
        raise ValueError(
            f"a PPO {{params, obs_norm}} checkpoint has 8 + 4 x (hidden layers) "
            f"leaves; this one has {n}"
        )
    n_hidden = (n - 8) // 4
    names = _ppo_names(n_hidden)
    obs_size, action_size = leaves[0].shape[-1], leaves[-1].shape[-1]
    hidden = tuple(leaves[3 + 2 * i].shape[-1] for i in range(n_hidden))  # actor_i biases
    widths = (obs_size, *hidden)
    want = [("obs_norm.mean", (obs_size,)), ("obs_norm.var", (obs_size,)), ("obs_norm.count", ())]
    for name in names:
        if name == "log_std":
            want.append((name, (action_size,)))
            continue
        tower, _, idx = name.partition("_")
        n_out = {"actor": action_size, "critic": 1}[tower] if idx == "out" else widths[int(idx) + 1]
        n_in = widths[-1] if idx == "out" else widths[int(idx)]
        want += [(f"{name}.bias", (n_out,)), (f"{name}.kernel", (n_in, n_out))]
    for i, (arr, (field, shape)) in enumerate(zip(leaves, want)):
        if arr.shape != shape or arr.dtype != np.float32:
            raise ValueError(
                f"leaf_{i} ({field}): want float32 {shape}, got {arr.dtype} {arr.shape}"
            )
    net = ActorCritic(obs_size, action_size, hidden, compute_dtype=compute_dtype, device="cpu")
    it = iter(leaves[3:])
    with torch.no_grad():
        for name in names:
            if name == "log_std":
                net.log_std.copy_(torch.from_numpy(next(it)))
            else:
                layer = _ppo_layer(net, name)
                layer.bias.copy_(torch.from_numpy(next(it)))
                layer.weight.copy_(torch.from_numpy(next(it).T))
    obs_norm = ObsNorm(*(torch.from_numpy(a).to(device) for a in leaves[:3]))
    return net.to(device), obs_norm


def load_ppo_checkpoint(path: str, device="cuda"):
    """A shipped ``{params, obs_norm}`` ``.npz`` (e.g.
    ``artifacts/vss_ppo.ckpt.npz``) -> (ActorCritic, ObsNorm), no jax."""
    from rsoccer_tpu_torch.utils.checkpoint import load_leaves

    return ppo_from_leaves(load_leaves(path), device=device)


def _np(t):
    return t.detach().cpu().numpy()


def _check_leaves(leaves, want, what):
    for i, (arr, (field, shape)) in enumerate(zip(leaves, want)):
        if arr.shape != shape or arr.dtype != np.float32:
            raise ValueError(f"{what} leaf_{i} ({field}): want float32 {shape}, got {arr.dtype} {arr.shape}")


def _sac_actor_names(n_hidden: int) -> list[str]:
    """The flax SquashedGaussianActor's layer names in the JAX leaf order."""
    return sorted([f"fc{i}" for i in range(n_hidden)] + ["log_std", "mean"])


def _sac_actor_layer(actor, name: str):
    return actor.tower[int(name[2:])] if name.startswith("fc") else getattr(actor, name)


def sac_actor_to_numpy(actor) -> dict:
    """SquashedGaussianActor -> the JAX package's ``actor_params`` tree
    with numpy leaves (flax names, kernels ``(in, out)``)."""
    params = {}
    for name in _sac_actor_names(len(actor.hidden)):
        layer = _sac_actor_layer(actor, name)
        params[name] = {"bias": _np(layer.bias), "kernel": _np(layer.weight).T.copy()}
    return {"params": params}


def _dim(arr, axis: int) -> int:
    """``arr.shape[axis]``, or -1 (a size no layout has) where ``arr`` has
    fewer axes: the shape check then names the leaf."""
    return arr.shape[axis] if arr.ndim > axis else -1


def sac_actor_from_leaves(leaves, device="cuda", compute_dtype=torch.float32):
    """A SAC actor checkpoint's positional leaves (numpy, the table above)
    -> SquashedGaussianActor on ``device``.  Raises, naming the leaf, where
    the layout differs."""
    from rsoccer_tpu_torch.models.networks import check_device
    from rsoccer_tpu_torch.models.sac import SquashedGaussianActor

    device = check_device(device)
    leaves = [np.array(a) for a in leaves]  # writable copies
    n = len(leaves)
    if n < 6 or n % 2:
        raise ValueError(
            f"a SAC actor checkpoint has 4 + 2 x (hidden layers) leaves; this one has {n}"
        )
    n_hidden = (n - 4) // 2
    names = _sac_actor_names(n_hidden)
    obs_size, action_size = _dim(leaves[1], 0), _dim(leaves[-2], 0)
    hidden = tuple(_dim(leaves[2 * i], 0) for i in range(n_hidden))  # fc_i biases
    widths = (obs_size, *hidden)
    want = []
    for name in names:
        n_in, n_out = ((widths[int(name[2:])], widths[int(name[2:]) + 1]) if name.startswith("fc")
                       else (widths[-1], action_size))
        want += [(f"{name}.bias", (n_out,)), (f"{name}.kernel", (n_in, n_out))]
    _check_leaves(leaves, want, "SAC actor")
    actor = SquashedGaussianActor(obs_size, action_size, hidden, compute_dtype=compute_dtype,
                                  device="cpu")
    it = iter(leaves)
    with torch.no_grad():
        for name in names:
            layer = _sac_actor_layer(actor, name)
            layer.bias.copy_(torch.from_numpy(next(it)))
            layer.weight.copy_(torch.from_numpy(next(it).T))
    return actor.to(device)


def load_sac_checkpoint(path: str, device="cuda"):
    """A shipped SAC actor ``.npz`` (e.g. ``artifacts/sac_sd_best2.ckpt.npz``,
    or the BC warm start ``artifacts/sd_sac_bc.ckpt.npz``) ->
    SquashedGaussianActor (f32 towers), no jax."""
    from rsoccer_tpu_torch.utils.checkpoint import load_leaves

    return sac_actor_from_leaves(load_leaves(path), device=device)


def _sac_critic_names(n_hidden: int) -> list[str]:
    return sorted([f"fc{i}" for i in range(n_hidden)] + ["q"])


def _sac_critic_index(name: str, n_hidden: int) -> int:
    return n_hidden if name == "q" else int(name[2:])


def sac_critics_to_numpy(qs) -> dict:
    """TwinQCritic -> the JAX package's stacked ``qs_params`` tree with
    numpy leaves (leading axis 2, kernels ``(2, in, out)``)."""
    n = len(qs.hidden)
    return {"params": {
        name: {"bias": _np(qs.biases[_sac_critic_index(name, n)]),
               "kernel": _np(qs.kernels[_sac_critic_index(name, n)])}
        for name in _sac_critic_names(n)
    }}


def sac_critics_from_leaves(leaves, obs_size: int, device="cuda", compute_dtype=torch.float32):
    """The stacked twin critics' positional leaves -> TwinQCritic on
    ``device``; ``obs_size`` splits the first layer's input into obs and
    action.  Raises, naming the leaf, where the layout differs."""
    from rsoccer_tpu_torch.models.networks import check_device
    from rsoccer_tpu_torch.models.sac import TwinQCritic

    device = check_device(device)
    leaves = [np.array(a) for a in leaves]
    n = len(leaves)
    if n < 4 or n % 2:
        raise ValueError(f"stacked SAC critics have 2 + 2 x (hidden layers) leaves; these have {n}")
    n_hidden = (n - 2) // 2
    names = _sac_critic_names(n_hidden)
    hidden = tuple(_dim(leaves[2 * i], 1) for i in range(n_hidden))
    widths = (_dim(leaves[1], 1), *hidden, 1)
    want = []
    for name in names:
        i = _sac_critic_index(name, n_hidden)
        want += [(f"{name}.bias", (2, widths[i + 1])), (f"{name}.kernel", (2, widths[i], widths[i + 1]))]
    _check_leaves(leaves, want, "SAC critics")
    qs = TwinQCritic(obs_size, widths[0] - obs_size, hidden, compute_dtype=compute_dtype, device="cpu")
    it = iter(leaves)
    with torch.no_grad():
        for name in names:
            i = _sac_critic_index(name, n_hidden)
            qs.biases[i].copy_(torch.from_numpy(next(it)))
            qs.kernels[i].copy_(torch.from_numpy(next(it)))
    return qs.to(device)
