"""Actor-critic network of the port's PPO.

Port of ``rsoccer_tpu/models/networks.py``: a Gaussian policy and a value
critic with separate MLP towers.  The towers compute in ``compute_dtype``
(bfloat16 by default, as in the JAX package) on f32 parameters; the two
heads compute in f32.

The rounding points are the flax ones, written as explicit casts (no
``torch.autocast``): a flax ``Dense(dtype=bf16)`` casts its input, kernel
and bias to bf16, multiplies to a bf16 result and adds the bias in bf16;
tanh runs in bf16; each head takes the tower's output cast to f32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2PI_E = math.log(2.0 * math.pi * math.e)


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device on a
    machine without a card (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device is 'cuda' (the default) but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def _orthogonal_linear(n_in: int, n_out: int, gain: float, gen: torch.Generator) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    nn.init.orthogonal_(layer.weight, gain, generator=gen)
    nn.init.zeros_(layer.bias)
    return layer


class ActorCritic(nn.Module):
    """Gaussian-policy actor + value critic with separate towers.

    ``forward(obs (B, O)) -> (mean (B, A), log_std (A,), value (B,))``.
    Orthogonal init, gain sqrt(2) on the hidden layers, 0.01 on the policy
    head and 1.0 on the value head, zero biases: the standard PPO
    continuous-control recipe.  The parameters are drawn on the CPU from
    ``seed`` (the same values on every device), then moved to ``device``.
    """

    def __init__(
        self,
        obs_size: int,
        action_size: int,
        hidden: Sequence[int] = (256, 256),
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        device = check_device(device)
        self.obs_size = obs_size
        self.action_size = action_size
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype
        gen = torch.Generator().manual_seed(seed)
        widths = (obs_size, *self.hidden)
        g_hidden = math.sqrt(2.0)
        self.actor = nn.ModuleList(
            _orthogonal_linear(i, o, g_hidden, gen) for i, o in zip(widths, widths[1:])
        )
        self.actor_out = _orthogonal_linear(widths[-1], action_size, 0.01, gen)
        self.critic = nn.ModuleList(
            _orthogonal_linear(i, o, g_hidden, gen) for i, o in zip(widths, widths[1:])
        )
        self.critic_out = _orthogonal_linear(widths[-1], 1, 1.0, gen)
        self.log_std = nn.Parameter(torch.zeros(action_size))
        self.to(device)

    def _tower(self, layers, x):
        dt = self.compute_dtype
        for layer in layers:
            x = torch.tanh(F.linear(x, layer.weight.to(dt)) + layer.bias.to(dt))
        return x.float()

    def forward(self, obs):
        """obs (B, O) -> (mean (B, A), log_std (A,), value (B,))."""
        x = obs.to(self.compute_dtype)
        mean = self.actor_out(self._tower(self.actor, x))
        value = self.critic_out(self._tower(self.critic, x))[..., 0]
        return mean, self.log_std, value

    def policy_mean(self, obs):
        """The actor alone: obs (B, O) -> mean (B, A)."""
        return self.actor_out(self._tower(self.actor, obs.to(self.compute_dtype)))

    def actor_parameters(self) -> list:
        """The actor's parameters and ``log_std`` (what a critic warmup
        freezes)."""
        return [*self.actor.parameters(), *self.actor_out.parameters(), self.log_std]

    def value(self, obs):
        """The critic alone: obs (B, O) -> value (B,)."""
        return self.critic_out(self._tower(self.critic, obs.to(self.compute_dtype)))[..., 0]


def sample_action(gen, mean, log_std, noise=None):
    """Gaussian sample + log-prob: mean (B, A) -> (action (B, A), logp (B,)).
    ``noise``: the standard normals (B, A), else drawn from ``gen``."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=gen, device=mean.device, dtype=mean.dtype)
    action = mean + torch.exp(log_std) * noise
    return action, gaussian_logp(action, mean, log_std)


def gaussian_logp(action, mean, log_std):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * _LOG_2PI, dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * _LOG_2PI_E)
