"""The card's peaks and the least time a kernel's work could take on it.

The one home of the roofline's yardstick (``tools/roofline.py``,
``chip_smoke.py``):

- the NVIDIA H100 SXM data-sheet peaks at its 700 W limit (dense, no
  sparsity); a card set below 700 W (``nvidia-smi``'s ``power.limit``)
  runs slower under load, so a share of a peak goes beside the card's
  limit;
- the f32 operation counts of the fused env-step kernels K1, K2 and
  K4-K7, counted from the kernel sources (one per f32 add, multiply,
  divide, compare, min/max, square root or transcendental; each Philox
  block as 40);
- :func:`bound_ms`, the least time for one launch on given operands;
- the matmul FLOPs of a PPO train step and of a SAC iteration, from the
  towers' shapes and the step's call counts (what ``torch.profiler``
  counts for the matmul-class ops with ``with_flops=True``).
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12  # tensor cores, dense
BF16_FLOPS_PER_S = 989.4e12  # tensor cores, dense


def vss_full_ops(n):
    """K1's f32 operations per env (ops_env) and per done env (ops_reset),
    counted from the kernel source for n robots: OU + wheels ~17 per robot
    and the n + 1 Philox blocks of the OU slots; 5 substeps x (n robots x 30
    + n(n-1)/2 pairs x 25 + walls 8 per robot + ball 60 + n contacts x 20);
    obs ~10 per robot.  A reset: spawn placement (n + 1 entities x 8
    candidates against the points placed before, ~4 each, and their
    setup) and its 4(n + 1) Philox blocks, the theta block."""
    ops_env = 17 * n + (n + 1) * 40 + 5 * (38 * n + 25 * n * (n - 1) // 2 + 60 + 20 * n) + 10 * n
    ops_reset = 16 * n * (n + 1) + 32 * (n + 1) + 40 * (4 * (n + 1) + 1)
    return ops_env, ops_reset


def vss_physics_ops(n):
    """K2's f32 operations per env for n robots: commands and trig 12 per
    robot, 5 substeps x (n robots x 35 + n(n-1)/2 pairs x 35 + apply 4 and
    walls 16 per robot + ball 24 + n contacts x 28 + 4 + ball walls 20)."""
    return 12 * n + 5 * (55 * n + 35 * n * (n - 1) // 2 + 28 * n + 48)


# (ops_env, ops_reset) of the SSL steps K4-K7
# K4, SD: trig + actions ~40, 5 substeps x (7 robots x 20 + 21 pairs x 25
# + ball 45 + 7 contacts x 20 + 2 face zones x 12), shaping and obs ~120;
# a reset: ball 8 x 6, defenders 6 x 8 x (4.5 x 5 + 4), 30 Philox blocks
SD_OPS = (40 + 5 * (140 + 525 + 45 + 140 + 24) + 120, 48 + 6 * 8 * 27 + 30 * 40)
# K5, CP: trig + actions ~25, 5 substeps x (2 robots x 20 + 1 pair x 25 +
# ball 45 + 2 contacts x 20 + 2 face zones x 12), epilogue ~110; a reset:
# ~10 and one Philox block
CP_OPS = (25 + 5 * (40 + 25 + 45 + 40 + 24) + 110, 10 + 40)
# K6, DR: trig 10 + actions ~20, 5 substeps x (5 robots x 20 + 10 pairs x
# 25 + ball 45 + 5 contacts x 20 + 3 face zones x 12), epilogue (collision
# 8, box 5, automaton ~30, obs 21 x 4) ~130; a reset: ~20 stores, 2
# transcendentals
DR_OPS = (30 + 5 * (100 + 250 + 45 + 100 + 36) + 130, 22)
# K7, PE: trig 4 + actions ~5, 5 substeps x (2 robots x 20 + 1 pair x 25 +
# ball 45 + 2 contacts x 20 + 2 pull zones x 30 + 4 face zones x 12),
# epilogue (distances, bbox, counters, shaping ~55, obs 16 x 4) ~120; a
# reset: 5 Philox blocks, 16 candidates x 5, atan2, sin/cos, rsqrt ~35
PE_OPS = (9 + 5 * (40 + 25 + 45 + 40 + 60 + 48) + 120, 5 * 40 + 16 * 5 + 35)


def fused_step_ops(env) -> tuple[int, int]:
    """(ops_env, ops_reset) of the fused step kernel of ``env`` (exact
    type, as ``batch/vecenv``'s fused path picks the kernel)."""
    from rsoccer_tpu_torch.envs.ssl_contested_possession import SSLContestedPossessionEnv
    from rsoccer_tpu_torch.envs.ssl_dribbling import SSLDribblingEnv
    from rsoccer_tpu_torch.envs.ssl_pass_endurance import SSLPassEnduranceEnv
    from rsoccer_tpu_torch.envs.ssl_static_defenders import SSLStaticDefendersEnv
    from rsoccer_tpu_torch.envs.vss import VSSEnv

    ssl = {SSLStaticDefendersEnv: SD_OPS, SSLContestedPossessionEnv: CP_OPS,
           SSLDribblingEnv: DR_OPS, SSLPassEnduranceEnv: PE_OPS}
    if type(env) is VSSEnv:
        return vss_full_ops(env.n_robots)
    if type(env) in ssl:
        return ssl[type(env)]
    raise NotImplementedError(f"no fused step kernel for {type(env).__name__}")


def bound_ms(ins, outs, ops_env: int, ops_reset: int, n_done: int,
             hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> tuple[float, str, float, float]:
    """The least time for one launch on these operands: each input read
    once and each output written once over the HBM rate, against the f32
    operations over the f32 rate, ``ops_env`` per env (the last axis of
    ``ins[0]``) plus ``ops_reset`` per env that this launch resets.
    Returns (bound, "bytes" or "operations", bytes time, operations time),
    in ms.  The tensors may be on the ``meta`` device: only their shapes
    and dtypes count."""
    n_bytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    n_ops = ops_env * ins[0].shape[-1] + ops_reset * n_done
    t_bytes = n_bytes / hbm_bytes_per_s * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops


def matmul_peak_flops(dtype: torch.dtype) -> float:
    """The card's dense matmul peak for towers computing in ``dtype``: bf16
    on the tensor cores; f32 outside them unless torch lets cuBLAS use
    TF32 (``torch.backends.cuda.matmul.allow_tf32``, off by default)."""
    if dtype == torch.bfloat16:
        return BF16_FLOPS_PER_S
    if dtype == torch.float32:
        return TF32_FLOPS_PER_S if torch.backends.cuda.matmul.allow_tf32 else F32_OPS_PER_S
    raise ValueError(f"no matmul peak for {dtype}")


def _tower_flops(rows: int, widths) -> int:
    """2 x rows x in x out, summed over a tower's layers."""
    return sum(2 * rows * i * o for i, o in zip(widths, widths[1:]))


def ppo_matmul_flops(obs_size: int, action_size: int, hidden, n_envs: int, rollout_steps: int,
                     num_epochs: int, num_minibatches: int) -> int:
    """Matmul FLOPs of one ``PPOTrainer.train_step`` (``models/ppo.py``):
    per collect step the actor and critic on the obs and the critic on the
    final obs; the critic on the last obs; per minibatch of T x B / M rows
    the forward of both nets and the backward, which multiplies twice per
    layer (input and weight gradients) but once for each first layer,
    whose input, the obs, needs no gradient."""
    actor = (obs_size, *hidden, action_size)
    critic = (obs_size, *hidden, 1)
    fwd_actor, fwd_critic = _tower_flops(n_envs, actor), _tower_flops(n_envs, critic)
    collect = rollout_steps * (fwd_actor + 2 * fwd_critic) + fwd_critic
    rows = rollout_steps * n_envs // num_minibatches

    def fwd_bwd(widths):
        fwd = _tower_flops(rows, widths)
        return 3 * fwd - 2 * rows * widths[0] * widths[1]

    return collect + num_epochs * num_minibatches * (fwd_bwd(actor) + fwd_bwd(critic))


def sac_matmul_flops(obs_size: int, action_size: int, hidden, n_envs: int, batch_size: int,
                     grad_steps_per_iter: int, iterations: int, actor_collects: int) -> int:
    """Matmul FLOPs of ``iterations`` calls of ``SACTrainer.train_step``
    (``models/sac.py``) of which ``actor_collects`` collects ran the actor
    on the B envs (the others drew uniform warmup actions).  Per update, on
    a minibatch of N rows: the target (actor, the twin target critics),
    the critics' loss forward and backward (their first-layer input, the
    stored obs and action, needs no gradient), the actor loss (actor, twin
    critics) and its backward into the actor only, through the critics'
    input gradients, and the critic loss again as a metric."""
    actor = (obs_size, *hidden)
    heads = 2 * 2 * hidden[-1] * action_size  # mean and log_std, per row
    critic = (obs_size + action_size, *hidden, 1)
    n = batch_size

    def actor_fwd(rows):
        return _tower_flops(rows, actor) + rows * heads

    critic_fwd = 2 * _tower_flops(n, critic)  # the twins
    critic_bwd = 2 * critic_fwd - 2 * 2 * n * critic[0] * critic[1]
    update = actor_fwd(n) + critic_fwd  # the target
    update += critic_fwd + critic_bwd  # the critic loss
    update += actor_fwd(n) + critic_fwd  # the actor loss
    # its backward: the critics' input gradients (each first layer's too:
    # the action needs one), the actor's input and weight gradients but
    # its first layer's input gradient
    update += critic_fwd + 2 * actor_fwd(n) - 2 * n * actor[0] * actor[1]
    update += critic_fwd  # the metric
    return actor_collects * actor_fwd(n_envs) + iterations * grad_steps_per_iter * update
