"""The card's peaks and the least time of a piece of work on it.

A frozen copy of ``rsoccer_tpu_torch/ops/bounds.py``'s yardstick: the
NVIDIA H100 SXM data-sheet peaks at its 700 W limit.  The env steps' f32
operation counts per env live in the configuration files: estimates
counted from the kernel sources, labelled so there.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores


def least_s(n_bytes: float, n_f32_ops: float) -> float:
    """The least seconds for work that moves ``n_bytes`` through HBM and
    computes ``n_f32_ops`` f32 operations outside the tensor cores."""
    return max(n_bytes / HBM_BYTES_PER_S, n_f32_ops / F32_OPS_PER_S)


def env_step_least_s(cfg: dict, n_envs: int, resets: float) -> float:
    """The least seconds of one batched env step of configuration ``cfg``
    over ``n_envs`` envs, ``resets`` of which reset: the state read once
    and written once, the actions read, the obs and the output rows
    (reward, terminated, truncated, info) written, all f32; the per-env
    operations plus a reset's for each env that resets."""
    rows = 2 * cfg["state_rows"] + cfg["action_rows"] + cfg["obs_rows"] + cfg["out_rows"]
    return least_s(4.0 * rows * n_envs, cfg["ops_env"] * n_envs + cfg["ops_reset"] * resets)

