"""Roofline / MFU accounting for chained train steps (PPO or SAC).

The counterpart of the JAX package's ``tools/roofline.py``:

    python -m rsoccer_tpu_torch.tools.roofline --learner ppo --envs 4096 --chain 50 \\
        --fused --fused-rng kernel --num-epochs 2 --minibatch-mode time
    python -m rsoccer_tpu_torch.tools.roofline --learner sac --envs 512 --chain 200

Two warm-up calls of ``--chain`` train steps, then one under
``torch.profiler`` with ``with_flops=True`` (``tools/_trace.py``), read
into:

- device time by kernel class: ``gemm`` (the kernels that the matmul-class
  aten ops launched: cuBLAS and CUTLASS names, ``sm90_xmma`` among them),
  ``env`` (the fused env kernels K1-K7 by name), ``elementwise``,
  ``reduction``, ``memcpy/memset`` and ``other``; the classes sum to the
  device total;
- the matmul FLOPs the profiler counts (``aten::mm``, ``addmm``, ``bmm``,
  ``baddbmm``), beside the towers' count from their shapes
  (``ops/bounds.py``), and the achieved TFLOP/s over the device total and
  over the gemm kernels; MFU against the card's peak for the towers'
  dtype (``ops/bounds.matmul_peak_flops``: bf16 989.4 TFLOP/s for PPO's
  towers, f32 67 TFLOP/s for SAC's, TF32 being off in torch's default),
  or ``--peak-tflops``;
- the env kernel's device time per launch beside its bound
  (``ops/bounds.bound_ms`` on the step's operands, bytes over
  ``--peak-gbs``);
- the top ``--top`` kernels.

The JAX tool read XLA's per-op ``model_flops`` and ``bytes_accessed``.
``torch.profiler`` counts FLOPs for the matmul-class ops only and no
bytes, and reading the step's HBM traffic needs ``ncu``, which the card's
machine does not have: so there is no HBM share of the whole step
(``bw_pct``), only the env kernel's bound.  On the CPU (``--device cpu``)
the times are the CPU ops' self time on the host clock, and the plain
env step's own matmuls (the SSL wheel transform) count with the towers'.
``--json`` writes the JAX tool's summary keys (``us_per_iter``,
``env_steps_per_s``, ``achieved_tflops``, ``mfu_pct``, ``by_category``)
and the port's.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from rsoccer_tpu_torch.tools._trace import ENV_KERNELS, MATMUL_OPS

CATEGORIES = ("gemm", "env", "elementwise", "reduction", "memcpy/memset", "other")
_CUDA_CLASSES = (
    ("env", ENV_KERNELS),
    ("memcpy/memset", r"^Memcpy|^Memset|memcpy|memset"),
    ("reduction", r"reduce|Reduce|cub::"),
    ("elementwise", r"elementwise|multi_tensor_apply"),
)
_CPU_CLASSES = (
    ("memcpy/memset", r"copy|fill_|zero_"),
    ("reduction", r"::(sum|mean|amax|amin|max|min|norm|std|var|prod|cumsum|cumprod|argmax|all|any)$"),
    ("elementwise", r"^aten::"),
)


def classify(name: str, trace) -> str:
    """The class of one kernel (on the card) or CPU op (on the CPU)."""
    if name in trace.gemm_kernels or (trace.events == "cpu" and name in MATMUL_OPS):
        return "gemm"
    for cat, pat in _CUDA_CLASSES if trace.events == "cuda" else _CPU_CLASSES:
        if re.search(pat, name):
            return cat
    return "other"


def build(args, device):
    """(trainer, state, env steps per iteration, batched env steps per
    iteration, the towers' matmul FLOPs of one chained call given the
    state before it)."""
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.ops import bounds

    benv = rt.make_vec(args.env_id, args.envs, device=device, fused=args.fused, fused_rng=args.fused_rng)
    o, a = benv.obs_size, benv.action_size
    if args.learner == "ppo":
        from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer

        cfg = PPOConfig(rollout_steps=args.rollout_steps, minibatch_mode=args.minibatch_mode,
                        num_minibatches=args.num_minibatches, num_epochs=args.num_epochs)
        trainer = PPOTrainer(benv, cfg)
        per_step = bounds.ppo_matmul_flops(o, a, cfg.hidden, args.envs, cfg.rollout_steps,
                                           cfg.num_epochs, cfg.num_minibatches)
        return (trainer, trainer.init(0), cfg.rollout_steps * args.envs, cfg.rollout_steps,
                lambda st: per_step * args.chain)
    from rsoccer_tpu_torch.models.sac import SACConfig, SACTrainer

    cfg = SACConfig(batch_size=args.batch_size, warmup_steps=50, grad_steps_per_iter=2,
                    n_step=args.n_step, reward_scale=10.0)
    trainer = SACTrainer(benv, cfg)

    def flops(st):
        # collect j of the call runs the actor once the warmup collects are done
        actor_collects = sum(st.total_steps + j >= cfg.warmup_steps
                             for j in range(args.chain * cfg.env_steps_per_iter))
        return bounds.sac_matmul_flops(o, a, cfg.hidden, args.envs, cfg.batch_size,
                                       cfg.grad_steps_per_iter, args.chain, actor_collects)

    return trainer, trainer.init(0), args.envs * cfg.env_steps_per_iter, cfg.env_steps_per_iter, flops


def env_bound_us(benv, state, n_done: int, peak_gbs: float) -> tuple[float, str]:
    """The fused env kernel's bound (µs, "bytes" or "operations") for one
    collect step of the learners (``step_final``: the ``emit_final``
    variant) on ``state``'s shapes; the noise rows where the kernel takes
    them as input."""
    from rsoccer_tpu_torch.ops import bounds
    from rsoccer_tpu_torch.ops.philox import make_key

    b, env = benv.n_envs, benv.env
    key = make_key(0, device=state.device)
    noise = (key,) if benv.fused_rng == "kernel" else benv._ops.rows(env, *benv._draw(key))
    ins = (state, torch.empty((benv.action_size, b), device="meta"), *noise)
    outs = [torch.empty(shape, device="meta") for shape in
            (state.shape, (2 * benv.obs_size, b), (3 + len(benv._ops.info_keys), b))]
    bound, by, _, _ = bounds.bound_ms(ins, outs, *bounds.fused_step_ops(env), n_done,
                                      hbm_bytes_per_s=peak_gbs * 1e9)
    return bound * 1e3, by


def main(argv=None) -> dict:
    from rsoccer_tpu_torch.models.sac import Buffer, iteration_generator
    from rsoccer_tpu_torch.ops import bounds
    from rsoccer_tpu_torch.tools import _trace

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--learner", choices=["ppo", "sac"], default="ppo")
    p.add_argument("--env-id", default="SSLStaticDefenders-v0")
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--chain", type=int, default=50)
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument("--minibatch-mode", default="time")
    p.add_argument("--num-minibatches", type=int, default=8)
    p.add_argument("--num-epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=512)  # sac
    p.add_argument("--n-step", type=int, default=8)  # sac
    p.add_argument("--fused", action="store_true", help="the fused step kernel")
    p.add_argument("--fused-rng", default="input", choices=["input", "kernel"])
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="peak dense TFLOP/s for the MFU (default: the H100's for the towers' dtype, "
                   "ops/bounds.py)")
    p.add_argument("--peak-gbs", type=float, default=bounds.HBM_BYTES_PER_S / 1e9,
                   help="peak HBM GB/s for the env kernel's bound (H100 SXM: 3350)")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--out", default="chiprun_out/roofline")
    p.add_argument("--json", default="", help="also write the summary here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    trainer, state, steps_per_iter, launches_per_iter, towers_flops = build(args, device)
    box, last = [state], {}

    def call():
        last["before"] = box[0]
        for _ in range(args.chain):
            if args.learner == "ppo":
                box[0], last["m"] = trainer.train_step(box[0])
            else:
                box[0], last["m"] = trainer.train_step(box[0], iteration_generator(0, box[0].iteration, device))

    for _ in range(2):
        call()
    trainer.phase_ms()  # waits for the last step
    trace = _trace.profile(call, 1, args.out, device, name=f"roofline_{args.learner}", with_flops=True,
                           match=ENV_KERNELS, expect=launches_per_iter * args.chain if args.fused else 0)
    flops_analytic = towers_flops(last["before"])  # the state before the window kept

    by_cat = {c: {"us": 0.0, "launches": 0} for c in CATEGORIES}
    for name, (us, count) in trace.kernels.items():
        row = by_cat[classify(name, trace)]
        row["us"] += us
        row["launches"] += count
    total_us = trace.total_us
    total_s = total_us / 1e6
    dtype = box[0].net.compute_dtype if args.learner == "ppo" else trainer.cfg.compute_dtype
    peak = args.peak_tflops if args.peak_tflops is not None else bounds.matmul_peak_flops(dtype) / 1e12
    flops = trace.matmul_flops
    tflops = flops / total_s / 1e12
    gemm_s = by_cat["gemm"]["us"] / 1e6
    out = {
        "learner": args.learner, "env_id": args.env_id, "envs": args.envs, "chain": args.chain,
        "card": _trace.card_line(device), "events": trace.events, "timer": trace.timer,
        "us_per_iter": total_us / args.chain,
        "env_steps_per_s": steps_per_iter * args.chain / total_s,
        "busy_share": trace.busy_share,
        "matmul_flops": flops, "matmul_flops_towers": flops_analytic,
        "achieved_tflops": tflops,
        "gemm_tflops": flops / gemm_s / 1e12 if gemm_s > 0 else None,
        "towers_dtype": str(dtype).removeprefix("torch."), "peak_tflops": peak,
        "mfu_pct": 100 * tflops / peak,
        "by_category": {c: {"ms": v["us"] / 1e3, "share": v["us"] / total_us, "launches": v["launches"]}
                        for c, v in by_cat.items()},
        "trace": trace.path,
        "calls_run": trace.calls_run,
    }
    env = by_cat["env"]
    if env["launches"]:
        if args.learner == "ppo":
            n_done = float(last["m"]["mean_episode_ends"]) / args.rollout_steps
        else:
            buf, b = box[0].buffer, args.envs
            idx = torch.remainder(buf.ptr - b + torch.arange(b, device=device), buf.capacity)
            n_done = float(buf.rdb[idx, Buffer.B].sum())
        bound_us, by = env_bound_us(trainer.benv, box[0].env_state, round(n_done), args.peak_gbs)
        out["env_kernel"] = {"us_per_launch": env["us"] / env["launches"], "launches": env["launches"],
                             "bound_us": bound_us, "bound_by": by}
    what = "device busy" if trace.events == "cuda" else "CPU ops' self time"
    print(f"{what}: {total_us / 1e3:.2f} ms for {args.chain} iters ({out['us_per_iter']:.0f} us/iter; "
          f"{out['env_steps_per_s'] / 1e6:.3f}M env-steps/s at that rate; {trace.events} events, {trace.timer})")
    print(f"matmul FLOPs: {flops / 1e9:.3f} GFLOP (towers {flops_analytic / 1e9:.3f}) -> {tflops:.3f} TFLOP/s "
          f"= {out['mfu_pct']:.2f}% MFU (peak {peak:.1f} TF/s, {out['towers_dtype']} towers; {out['card']})")
    if "env_kernel" in out:
        e = out["env_kernel"]
        print(f"env kernel: {e['us_per_launch']:.2f} us per launch x {e['launches']}, bound {e['bound_us']:.3f} us "
              f"({e['bound_by']}, {args.peak_gbs:.0f} GB/s)")
    print("\nby kernel class:")
    print(f"{'class':16s} {'ms':>9s} {'%time':>6s} {'launches':>9s}")
    for c, v in sorted(out["by_category"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"{c:16s} {v['ms']:9.3f} {100 * v['share']:6.1f} {v['launches']:9d}")
    print(f"\ntop {args.top} kernels by time:")
    print(trace.table(args.top))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
