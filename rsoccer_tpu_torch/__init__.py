"""rsoccer_tpu_torch — the PyTorch/CUDA port of ``rsoccer_tpu``.

Same layout and names as the JAX package; batch-last tensors, NamedTuples
of tensors for state, an explicit ``device`` everywhere, and explicit keys
(``ops/philox.py``) instead of any global RNG.  Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU.  With
``fused=True`` the VSS-v0 step (every team size from 1v0 to 5v5) and the
four SSL tasks' steps each run as one hand-written CUDA kernel per step on
an NVIDIA card (``ops/vss_full.py``, ``ops/ssl_full.py``); with
``fused_physics=True`` VSS-v0's physics does (``ops/vss_physics.py``).
The learner: PPO (``models/networks.py``, ``models/ppo.py``) trains on
the batched envs, collecting through ``BatchedEnv.step_final``; the
JAX package's ``{params, obs_norm}`` checkpoints load through
``convert.load_ppo_checkpoint`` (``utils/checkpoint.py`` reads and writes
its ``.npz`` format); ``eval.py`` scores a policy
(``examples/train_ppo_vss.py``, ``tools/vss_anchor_eval.py``).  The
scripted experts (``experts.py``) act on batched states, and
``tools/bc_warmstart.py`` clones them into PPO or SAC actors (BC and
DAgger).  ``VSSMultiAgent-v0`` and ``VSSSelfPlay-v0`` run their physics
through the same VSS physics kernel, and ``models/selfplay.py`` trains a
learner against its frozen past (``examples/selfplay_vss.py``).
``parallel/`` shards the env batch, PPO and SAC over ``torch.distributed``
ranks (``tools/distributed_smoke.py``, ``tools/elastic_train.py``).
``tools/calibrate.py`` fits the VSS physics coefficients to trajectories
through the differentiable plain step; ``ops/native.py`` binds the C++
physics oracles (``csrc/*.cpp``).
Imports ``torch`` and never ``jax``.
"""

from rsoccer_tpu_torch.registry import make, registered_ids

__version__ = "0.1.0"


def make_vec(env_id: str, n_envs: int, device="cuda", fused: bool = False,
             fused_rng: str = "input", fused_physics: bool = False, **kwargs):
    """Create a :class:`~rsoccer_tpu_torch.batch.vecenv.BatchedEnv`
    directly; ``kwargs`` go to the env constructor.  The set-up phase
    ``rsoccer.setup.make_vec`` (``utils/tracing``)."""
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.utils import tracing

    with tracing.phase(tracing.SETUP_MAKE_VEC):
        return BatchedEnv(
            make(env_id, **kwargs), n_envs, device=device, fused=fused,
            fused_rng=fused_rng, fused_physics=fused_physics,
        )


__all__ = ["make", "make_vec", "registered_ids", "__version__"]
