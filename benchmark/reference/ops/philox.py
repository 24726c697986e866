"""Philox4x32-10 on int64 tensors: the port's one random stream.

The plain twin of ``csrc/philox.cuh``.  Every random word the port draws
comes from ONE mapping

    (key[2], step, env, slot) -> u32
    counter = (env, slot // 4, step_lo, step_hi), word = slot % 4

where ``env`` is the global env index: ``env_base`` plus the column.
``env_base`` is 0 unless the batch is one shard of a larger one
(``parallel/``): shard ``r`` of ``W`` then draws the words that columns
``[r B, (r + 1) B)`` of the unsharded batch draw.  So the fused kernel's in-kernel draws (``fused_rng="kernel"``) and the
plain ``envs/base.draw_noise`` (``fused_rng="input"``, the XLA-style twin
path) give the same numbers on any device.  A key is a small int64 tensor
``[k0, k1, step]`` that lives on the device of the data it feeds: the
kernel reads it through a pointer, and whoever consumes a draw advances
``step`` with an in-stream ``add_`` — no host sync, nothing a CUDA graph
would freeze.

u32 arithmetic on int64 tensors: Philox needs the full 64-bit product of
two u32 words, which overflows int64, and torch has no usable uint32
multiply on the CPU.  Each multiplier is split into 16-bit halves, so every
partial product stays below 2^48.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
N_ROUNDS = 10
# the counter's last word in a fold_in draw: no env step reaches a step
# whose high word is this, so a folded key never repeats a step's words
_FOLD_TAG = 0xF01D_0001


def make_key(seed: int, stream: int = 0, device="cuda") -> torch.Tensor:
    """Key tensor ``[k0, k1, step=0]`` for ``seed``; ``stream`` separates
    independent streams drawn from one seed."""
    k0 = seed & _MASK
    k1 = ((seed >> 32) ^ (stream * _W0)) & _MASK
    return torch.tensor([k0, k1, 0], dtype=torch.int64, device=device)


def _mulhilo(m: int, b):
    """(hi, lo) 32-bit words of ``m * b`` for a constant u32 ``m`` and an
    int64 tensor ``b`` holding u32 values."""
    p_lo = b * (m & 0xFFFF)  # < 2^48
    p_hi = b * (m >> 16)  # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11).  All args int64 tensors (or
    ints) holding u32 values, broadcast together; returns the 4 output
    words as int64 tensors."""
    for r in range(N_ROUNDS):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(key: torch.Tensor, n_slots: int, batch: int, first_block: int = 0,
                 env_base: int = 0) -> torch.Tensor:
    """Words for slots ``[4 * first_block, 4 * first_block + n_slots)`` of
    the envs ``[env_base, env_base + batch)`` at ``key``'s current step:
    ``(n_slots, batch)`` int64 in [0, 2^32).  Does not advance.  The env
    steps draw from block 0 up; a draw beside them (``models/selfplay``'s
    OU lanes) starts at a block no env step reaches."""
    dev = key.device
    n_blk = -(-n_slots // 4)
    if not 0 <= first_block <= _MASK - n_blk:
        raise ValueError(f"first_block {first_block} leaves the 32-bit block counter")
    if not 0 <= env_base <= _MASK + 1 - batch:
        raise ValueError(f"env_base {env_base} with {batch} envs leaves the 32-bit env counter")
    env = env_base + torch.arange(batch, dtype=torch.int64, device=dev)[None, :]
    blk = first_block + torch.arange(n_blk, dtype=torch.int64, device=dev)[:, None]
    step = key[2]
    words = philox4x32(
        env, blk, step & _MASK, (step >> 32) & _MASK, key[0], key[1]
    )
    return torch.stack(words, dim=1).reshape(4 * n_blk, batch)[:n_slots]


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A new key for an independent stream derived from ``key`` and the
    integer ``data`` (the counterpart of ``jax.random.fold_in``): ``[k0',
    k1']`` are the first two words of Philox at counter ``(data, 0, 0,
    _FOLD_TAG)`` under ``key``'s ``[k0, k1]``; the step is kept.  Device
    ops only (no host sync)."""
    data = int(data) & _MASK
    w0, w1, _, _ = philox4x32(data, 0, 0, _FOLD_TAG, key[0], key[1])
    return torch.stack([w0, w1, key[2]])


def uniforms_from_words(words: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> f32 uniform in [0, 1), exactly representable."""
    return (words >> 8).to(torch.get_default_dtype()) * (2.0 ** -24)


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normals, cos branch; ``u1`` clamped away from 0."""
    u1 = torch.clamp_min(u1, 1e-7)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.283185307179586 * u2)
