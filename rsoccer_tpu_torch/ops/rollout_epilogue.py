"""The rollout loop's per-step bookkeeping as one CUDA kernel launch.

``batch/rollout.make_rollout_fn`` on the card calls :func:`epilogue` once
a step and :func:`finish` once a call (``csrc/rollout_epilogue.cu``): the
episode accumulators' update and the four metric sums, which the plain
loop runs as ~24 small torch launches a step.  It replaces no TPU kernel
(the JAX package's scan lets XLA fuse them); its plain version is that
loop's torch bookkeeping (``batch/rollout.make_step_fn`` with
``rollout_metrics``), which runs on the CPU: these wrappers take CUDA
tensors only and raise on anything else.

The per-env carries are the plain loop's bits; the sums are taken in
float64 in a fixed order (each block of the step's fixed grid adds to its
own slot of a ``(4, SLOTS)`` scratch, the finish sums the slots), so two runs
agree bit for bit and the float32 sums are nearer the exact ones than the
plain loop's per-step float32 sums.

Each launch counts in ``utils/tracing``'s table under
``rollout_epilogue``: C entry ``rollout_epilogue`` once a step,
``rollout_epilogue_finish`` once a call.
"""

from __future__ import annotations

import torch

from rsoccer_tpu_torch.ops import _build
from rsoccer_tpu_torch.utils import tracing

WRAPPER = "rollout_epilogue"
N_SUMS = 4  # reward, episodes, completed returns, completed lengths
SLOTS = 1024  # the step's most blocks, each with its slot (kMaxSlots in the .cu)


def scratch(device) -> torch.Tensor:
    """The ``(4, SLOTS)`` float64 scratch of one call; the call's first
    :func:`epilogue` (``first=True``) fills the slots its grid uses, so it
    starts empty."""
    return torch.empty((N_SUMS, SLOTS), dtype=torch.float64, device=device)


def _check_cuda(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise NotImplementedError(f"{name}: the rollout epilogue runs on CUDA tensors, got {t.device}")


def epilogue(reward, term, trunc, ep_return, ep_length, acc, first: bool):
    """One step's bookkeeping: returns the new ``(ep_return, ep_length)``
    (zeroed where ``term | trunc``) and adds the step's four sums to
    ``acc`` (stores them where ``first``)."""
    _check_cuda(ep_return, "ep_return")
    dev, b = ep_return.device, ep_return.shape[-1]
    for t, name, dtype in ((reward, "reward", None), (ep_return, "ep_return", None),
                           (ep_length, "ep_length", None), (term, "term", torch.bool),
                           (trunc, "trunc", torch.bool)):
        _build.check_operand(t, name, (), b, dev, dtype)
    _build.check_operand(acc, "acc", N_SUMS, SLOTS, dev, torch.float64)
    ret_out = torch.empty_like(ep_return)
    len_out = torch.empty_like(ep_length)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.rollout_epilogue(
            reward.data_ptr(), term.data_ptr(), trunc.data_ptr(), ep_return.data_ptr(),
            ep_length.data_ptr(), ret_out.data_ptr(), len_out.data_ptr(), acc.data_ptr(),
            int(not first), b, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rollout_epilogue kernel launch failed: cudaError {err}")
    tracing.launched(WRAPPER, "rollout_epilogue", False)
    return ret_out, len_out


def finish(acc, batch: int):
    """The call's ``(total_reward, episodes, episode_return_sum,
    episode_length_sum)`` from the scratch of a batch of ``batch`` envs:
    float32, int64, float32, float32 device scalars."""
    _check_cuda(acc, "acc")
    dev = acc.device
    _build.check_operand(acc, "acc", N_SUMS, SLOTS, dev, torch.float64)
    sums = torch.empty((3,), dtype=torch.float32, device=dev)
    episodes = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().rollout_epilogue_finish(
            acc.data_ptr(), batch, sums.data_ptr(), episodes.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rollout_epilogue_finish kernel launch failed: cudaError {err}")
    tracing.launched(WRAPPER, "rollout_epilogue_finish", False)
    return sums[0], episodes, sums[1], sums[2]
