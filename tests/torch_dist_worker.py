"""One rank of the port's multi-process CPU tests (gloo, a FileStore).

``launch`` / ``start`` (called by ``tests/test_torch_parallel.py`` and
``tests/test_torch_distributed.py``) start one ``python -m
tests.torch_dist_worker TASK RANK WORLD STORE SPEC_JSON OUT_PT`` per rank,
each with its own timeout.  A rank imports only torch and the port (the
JAX side of a comparison runs in the test process and hands its draws over
as ``.npz``), runs one task on its shard and writes its results with
``torch.save``:

- ``rollout``: ``parallel/rollout.make_sharded_rollout`` (and its
  ``shard_map`` variant) on the plain path, the rank's final state, obs,
  key and the global metrics;
- ``sac_fed``: ``parallel/sac.make_sharded_sac`` from a state and per-shard
  draws the test made with the JAX package (``spec["draws"]``), the rank's
  final networks and ring count;
- ``init``: the sharded SAC's or PPO's ``init`` from a seed of the rank's
  own (its rank), the rank's networks.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import uuid

import numpy as np
import torch

import rsoccer_tpu_torch as rt
from rsoccer_tpu_torch.parallel import mesh as M


def rollout(mesh, spec: dict) -> dict:
    from rsoccer_tpu_torch.batch.rollout import init_carry
    from rsoccer_tpu_torch.parallel.rollout import (
        make_shard_map_rollout, make_sharded_rollout, shard_carry,
    )

    benv = rt.make_vec(spec["env_id"], spec["envs"], device="cpu", fused=spec["fused"],
                       fused_rng=spec["fused_rng"])
    if spec["impl"] == "jit":
        roll, init = make_sharded_rollout(benv, mesh, spec["steps"])
        carry = init(spec["seed"])
    else:
        roll = make_shard_map_rollout(benv, mesh, spec["steps"])
        carry = shard_carry(init_carry(benv, spec["seed"]), mesh)
    carry, ms = roll(carry)
    carry, ms2 = roll(carry)  # a second call: the carry goes on
    return {"state": carry.state, "obs": carry.obs, "key": carry.key,
            "metrics": [stacked(ms), stacked(ms2)]}


def sac_fed(mesh, spec: dict, npz) -> dict:
    from rsoccer_tpu_torch import convert
    from rsoccer_tpu_torch.models import sac as tsac
    from rsoccer_tpu_torch.parallel.sac import make_sharded_sac
    from rsoccer_tpu_torch.utils import checkpoint

    benv = rt.make_vec(spec["env_id"], spec["envs"], device="cpu")
    cfg = tsac.SACConfig(**spec["cfg"], hidden=tuple(spec["hidden"]))
    local, init, step = make_sharded_sac(benv, cfg, mesh)
    like = local.state_tree(init(0))
    state = local.state_from_tree(checkpoint.restore(spec["state"], like=like))

    def arr(name):
        return torch.from_numpy(np.array(npz[name]))

    t_names, r_names = spec["t_names"], spec["r_names"]
    collects = [tsac.CollectDraws(
        normal=arr(f"c{i}_normal"), uniform=arr(f"c{i}_uniform"),
        env=({k: arr(f"c{i}_t_{k}") for k in t_names}, {k: arr(f"c{i}_r_{k}") for k in r_names}))
        for i in range(spec["iters"])]
    n_upd = spec["iters"] * cfg.grad_steps_per_iter
    updates = [tsac.UpdateDraws(offsets=arr(f"u{j}_offsets").long(), next_eps=arr(f"u{j}_next_eps"),
                                pi_eps=arr(f"u{j}_pi_eps")) for j in range(n_upd)]
    c_it, u_it = iter(collects), iter(updates)
    local.collect_draws = lambda state, gen: next(c_it)
    local.update_draws = lambda state, gen: next(u_it)
    for i in range(spec["iters"]):
        state, metrics = step(state, 0, i)
    return {"actor": convert.sac_actor_to_numpy(state.actor),
            "qs": convert.sac_critics_to_numpy(state.qs),
            "qs_target": convert.sac_critics_to_numpy(state.qs_target),
            "log_alpha": state.log_alpha.detach(), "filled": state.buffer.filled,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def learner_init(mesh, spec: dict) -> dict:
    from rsoccer_tpu_torch.models.ppo import PPOConfig, PPOTrainer
    from rsoccer_tpu_torch.models.sac import SACConfig
    from rsoccer_tpu_torch.parallel.sac import make_sharded_sac

    benv = rt.make_vec(spec["env_id"], spec["envs"], device="cpu")
    if spec["learner"] == "sac":
        _, init, _ = make_sharded_sac(benv, SACConfig(**spec["cfg"], hidden=tuple(spec["hidden"])), mesh)
        state = init(mesh.rank)
        nets = [state.actor, state.qs, state.qs_target]
    else:
        state = PPOTrainer(benv, PPOConfig(**spec["cfg"], hidden=tuple(spec["hidden"])), mesh=mesh).init(mesh.rank)
        nets = [state.net]
    return {"params": [p.detach().clone() for m in nets for p in m.parameters()]}


def fake_mesh(rank: int, world: int):
    """A mesh without a process group: for the helpers that need none."""
    return M.EnvMesh(rank=rank, world=world, device=torch.device("cpu"))


def stacked(ms) -> torch.Tensor:
    """Rollout metrics as one f64 vector."""
    return torch.stack([m.double() for m in ms])


def shard_map_replay(benv, world, n_steps, seed, calls=2):
    """What make_shard_map_rollout computes, shard by shard in one process:
    each shard's columns of the global init, its keys folded with its
    rank, the plain rollout of its envs; the metrics summed."""
    from rsoccer_tpu_torch.batch import rollout as R
    from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
    from rsoccer_tpu_torch.ops.philox import fold_in
    from rsoccer_tpu_torch.parallel.rollout import fold_generator, shard_carry

    local = BatchedEnv(benv.env, benv.n_envs // world, device="cpu", fused=benv.fused,
                       fused_rng=benv.fused_rng)
    roll = R.make_rollout_fn(local, n_steps)
    g = R.init_carry(benv, seed)
    carries = [shard_carry(g, fake_mesh(r, world)) for r in range(world)]
    metrics = []
    for _ in range(calls):
        total = 0.0
        for r in range(world):
            c = carries[r]
            key0 = fold_in(c.key, 0)
            out, ms = roll(c._replace(key=fold_in(c.key, r), pol_gen=fold_generator(c.pol_gen, r)))
            key0[2] = out.key[2]
            torch.empty((1,)).random_(generator=c.pol_gen)
            carries[r] = out._replace(key=key0, pol_gen=c.pol_gen)
            total = total + stacked(ms)
        metrics.append(total)
    return carries, metrics


def spawn(argvs, timeout: float = 120.0):
    """Start ``python -m <argv>`` for each argv of ``argvs`` at once, from
    the repo's root, one thread each; returns ``finish()``, which waits for
    them and returns ``[(returncode, stdout, stderr)]`` in order, killing
    any process that outlives ``timeout`` seconds (``TimeoutExpired``)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-m", *argv], cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for argv in argvs]

    def finish() -> list:
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
        return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]

    return finish


def start(task: str, world: int, spec: dict, tmp_path, timeout: float = 120.0):
    """Start ``task`` on ``world`` ranks (processes, gloo, a FileStore under
    ``tmp_path``); returns ``finish()``, which waits for them and returns
    each rank's results in rank order.  ``finish`` fails on a rank that
    exits non-zero or outlives ``timeout`` seconds."""
    tag = f"{task}_{uuid.uuid4().hex[:8]}"  # a fresh store per launch
    spec_path = tmp_path / f"{tag}_spec.json"
    spec_path.write_text(json.dumps(spec))
    outs = [tmp_path / f"{tag}_rank{r}.pt" for r in range(world)]
    wait = spawn([["tests.torch_dist_worker", task, str(r), str(world), str(tmp_path / f"{tag}_store"),
                   str(spec_path), str(outs[r])] for r in range(world)], timeout)

    def finish() -> list:
        for r, (rc, _, err) in enumerate(wait()):
            if rc != 0:
                raise AssertionError(f"rank {r} of {world} exited {rc}:\n{err[-3000:]}")
        return [torch.load(o, weights_only=False) for o in outs]

    return finish


def launch(task: str, world: int, spec: dict, tmp_path, timeout: float = 120.0) -> list:
    """:func:`start` and wait: each rank's results, in rank order."""
    return start(task, world, spec, tmp_path, timeout)()


def main(argv) -> int:
    task, rank, world, store, spec_path, out = argv
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    M.initialize_distributed("gloo", f"file://{store}", int(world), int(rank))
    try:
        mesh = M.make_env_mesh("cpu")
        if task == "rollout":
            res = rollout(mesh, spec)
        elif task == "init":
            res = learner_init(mesh, spec)
        else:
            with np.load(spec["draws"].format(rank=rank)) as npz:
                spec["state"] = spec["state"].format(rank=rank)
                res = sac_fed(mesh, spec, npz)
        torch.save(res, out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
