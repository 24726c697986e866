"""The port's tools (``rsoccer_tpu_torch/tools/``: bench_all, profile_step,
profile_ppo, profile_sac, roofline, sd_spawn_slice) held to the JAX
package's tools (``tools/`` at the repo root): the same flags with the
same defaults, the same spawn features and bins, the accumulators of a
short spawn slice against a numpy recount, the kernels' bounds
(``ops/bounds.py``) against the numbers PERF.md lists, the roofline's
matmul FLOPs against the count the towers' shapes give, and each tool's
``main`` on the CPU at a tiny size, labelled as host-clock CPU numbers."""

import argparse
import ast
import importlib
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu.utils.cache
import rsoccer_tpu_torch as rt
from rsoccer_tpu.batch.vecenv import BatchedEnv as JaxBatchedEnv
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.envs.ssl_static_defenders import SDState
from rsoccer_tpu_torch.models.ppo import make_policy
from rsoccer_tpu_torch.models.sac import SACConfig, SACTrainer, iteration_generator
from rsoccer_tpu_torch.ops import bounds
from rsoccer_tpu_torch.ops import ssl_full as sf
from rsoccer_tpu_torch.ops import vss_full as vf
from rsoccer_tpu_torch.ops import vss_physics as vp
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.tools import _trace, roofline, sd_spawn_slice

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SD_PPO3 = os.path.join(REPO, "artifacts", "sd_ppo3.ckpt")
TOOLS = ("bench_all", "profile_step", "profile_ppo", "profile_sac", "roofline", "sd_spawn_slice")
# JAX flag -> the port's name for it (the TPU kernel switches became the
# fused-kernel switches; the default stays)
RENAMED = {"--pallas": "--mode", "--pallas-full": "--fused", "--pallas-rng": "--fused-rng"}
# JAX flags with no counterpart: a lax.scan unroll and the TPU's key
# implementation (the port has one Philox stream)
DROPPED = {"--rollout-unroll", "--rng-impl"}
# flags whose default changes: the TPU v5e peaks become the H100's, and
# outputs go under the checkout's chiprun_out/ (not /tmp, not artifacts/)
NEW_DEFAULT = {"--peak-tflops", "--peak-gbs", "--out"}
# PERF.md section 6: the bounds at 8192 envs, kernel RNG, by bytes (µs)
PERF_BOUNDS_US = {"K1": 1.73, "K2": 0.94, "K4": 1.51, "K5": 0.85, "K6": 1.02, "K7": 0.67}


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__("parsed")
        self.parser = parser


def _raise_parser(self, *args, **kwargs):
    raise _Parsed(self)


def _jax_tool(name, monkeypatch):
    """The JAX package's ``tools/<name>.py`` as a module, its persistent
    compile cache left untouched."""
    monkeypatch.setattr(rsoccer_tpu.utils.cache, "enable_persistent_cache", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parser_of(main, monkeypatch, *args):
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", _raise_parser)
    with pytest.raises(_Parsed) as got:
        main(*args)
    return got.value.parser


def _flags(parser) -> dict:
    return {a.option_strings[-1]: a.default for a in parser._actions
            if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("tool", TOOLS)
def test_flags_match_the_jax_tools(tool, monkeypatch):
    jax_flags = _flags(_parser_of(_jax_tool(tool, monkeypatch).main, monkeypatch))
    port = importlib.import_module(f"rsoccer_tpu_torch.tools.{tool}")
    port_flags = _flags(_parser_of(port.main, monkeypatch, []))
    assert port_flags["--device"] == "cuda"
    for flag, default in jax_flags.items():
        if flag in DROPPED:
            assert flag not in port_flags
            continue
        name = RENAMED.get(flag, flag)
        assert name in port_flags, f"{tool}: no counterpart of {flag}"
        if flag not in NEW_DEFAULT:
            assert port_flags[name] == default, (tool, flag, port_flags[name], default)
    if tool == "roofline":
        assert port_flags["--peak-tflops"] is None  # the towers' dtype's H100 peak
        assert port_flags["--peak-gbs"] == pytest.approx(3350.0)


def _main_literals(path: str) -> dict:
    """The literal lists and tuples assigned to names inside ``main`` of a
    module's source."""
    tree = ast.parse(open(path).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    out = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, (ast.List, ast.Tuple)):
            try:
                out[node.targets[0].id] = list(ast.literal_eval(node.value))
            except ValueError:
                pass
    return out


def test_spawn_features_and_bins_match_jax(monkeypatch):
    jmod = _jax_tool("sd_spawn_slice", monkeypatch)
    consts = _main_literals(os.path.join(REPO, "tools", "sd_spawn_slice.py"))
    assert sd_spawn_slice.D_EDGES == jmod.D_EDGES and sd_spawn_slice.X_EDGES == jmod.X_EDGES
    assert sd_spawn_slice.LABELS_D == consts["labels_d"] and sd_spawn_slice.LABELS_X == consts["labels_x"]
    assert list(sd_spawn_slice.MODES) == consts["modes"]
    env = rsoccer_tpu.make("SSLStaticDefenders-v0")
    for seed in (0, 1):
        state, _ = JaxBatchedEnv(env, 48).reset(jax.random.PRNGKey(seed))
        jd, jx = (np.asarray(v) for v in jmod._spawn_features(state))
        ts = convert.state_from_numpy(jax.tree.map(np.asarray, state), SDState, device="cpu")
        td, tx = sd_spawn_slice._spawn_features(ts)
        np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-6)


def test_spawn_slice_accumulators_equal_a_numpy_recount():
    """A short fused run with sd_ppo3 (32 envs x 150 steps: ~30 episodes):
    the tool's accumulators equal a numpy recount of the same steps."""
    n_envs, n_steps = 32, 150
    net, obs_norm = convert.load_ppo_checkpoint(SD_PPO3, device="cpu")
    policy = make_policy(net, obs_norm, deterministic=True)
    benv = rt.make_vec("SSLStaticDefenders-v0", n_envs, device="cpu", fused=True, fused_rng="kernel")
    acc = {k: v.numpy() for k, v in sd_spawn_slice.spawn_slice(benv, policy, n_steps).items()}

    def features(st):
        w = benv.unpack_state(st).world
        x, y = w.robots.x.numpy(), w.robots.y.numpy()
        bx, by = w.ball.x.numpy(), w.ball.y.numpy()
        return np.sqrt((x[1:] - bx) ** 2 + (y[1:] - by) ** 2).min(axis=0), bx

    key = make_key(sd_spawn_slice.SEED, device="cpu")
    gen = torch.Generator().manual_seed(sd_spawn_slice.SEED)
    st, obs = benv.reset(key)
    sd, sbx = features(st)
    want = {"d_count": np.zeros(5), "d_goals": np.zeros(5), "x_count": np.zeros(5), "x_goals": np.zeros(5),
            "modes": np.zeros((5, 5))}
    for _ in range(n_steps):
        st, obs, reward, term, trunc, info = benv.step(st, policy(gen, obs), key)
        done = (term | trunc).numpy()
        goal = reward.numpy() > 4.0
        db = np.searchsorted(sd_spawn_slice.D_EDGES, sd, side="left")
        xb = np.searchsorted(sd_spawn_slice.X_EDGES, sbx, side="left")
        for lane in np.flatnonzero(done):
            want["d_count"][db[lane]] += 1
            want["d_goals"][db[lane]] += goal[lane]
            want["x_count"][xb[lane]] += 1
            want["x_goals"][xb[lane]] += goal[lane]
            for i, m in enumerate(sd_spawn_slice.MODES):
                want["modes"][i, db[lane]] += float(info[m][lane])
        nd, nx = features(st)
        sd, sbx = np.where(done, nd, sd), np.where(done, nx, sbx)
    assert want["d_count"].sum() >= 10  # episodes ended
    for k in want:
        np.testing.assert_array_equal(acc[k], want[k], err_msg=k)
    out = sd_spawn_slice.report({k: torch.from_numpy(v) for k, v in acc.items()})
    assert out["episodes"] == int(want["d_count"].sum()) == int(want["x_count"].sum())
    assert sum(out["termination_modes_by_defender_dist"]["goal"].values()) == int(want["d_goals"].sum())


def _meta_at(t: torch.Tensor, b: int) -> torch.Tensor:
    """``t``'s shape with its batch axis (the last of a 2-D operand) at ``b``."""
    shape = (*t.shape[:-1], b) if t.dim() >= 2 else t.shape
    return torch.empty(shape, dtype=t.dtype, device="meta")


def _kernel_operands(kernel: str, b: int = 16):
    """(ins, outs, ops_env, ops_reset) of one launch of ``kernel`` at ``b``
    envs through its plain version on the CPU (kernel RNG)."""
    gen = torch.Generator().manual_seed(0)
    if kernel == "K2":
        env = rt.make("VSS-v0")
        st, _ = BatchedEnv(env, b, device="cpu").reset(make_key(0, device="cpu"))
        rb, bl = vp._stack(st.world)
        cmd = torch.rand((2, env.n_robots, b), generator=gen) * 2 - 1
        return (rb, bl, cmd), vp.vss_physics(env, rb, bl, cmd), bounds.vss_physics_ops(env.n_robots), 0, 0
    env_id, step = {"K1": ("VSS-v0", vf.vss_full_step), "K4": ("SSLStaticDefenders-v0", sf.sd_full_step),
                    "K5": ("SSLContestedPossession-v0", sf.cp_full_step), "K6": ("SSLDribbling-v0", sf.dr_full_step),
                    "K7": ("SSLPassEndurance-v0", sf.pe_full_step)}[kernel]
    benv = rt.make_vec(env_id, b, device="cpu", fused=True, fused_rng="kernel")
    key = make_key(3, device="cpu")
    st, _ = benv.reset(key)
    act = torch.rand((benv.action_size, b), generator=gen) * 2 - 1
    ins = (st, act, key.clone())
    return ins, step(benv.env, st, act, key=key), *bounds.fused_step_ops(benv.env), 0


@pytest.mark.parametrize("kernel", sorted(PERF_BOUNDS_US))
def test_bounds_are_perf_mds_at_8192_envs(kernel):
    ins, outs, ops_env, ops_reset, n_done = _kernel_operands(kernel)
    bound, by, t_bytes, t_ops = bounds.bound_ms([_meta_at(t, 8192) for t in ins],
                                                [_meta_at(t, 8192) for t in outs], ops_env, ops_reset, n_done)
    assert by == "bytes" and t_bytes > t_ops
    assert bound * 1e3 == pytest.approx(PERF_BOUNDS_US[kernel], rel=0.01)


def _dense(rows, widths):
    """Each layer's matmul FLOPs, 2 x rows x in x out."""
    return [2 * rows * i * o for i, o in zip(widths, widths[1:])]


def _ppo_flops(o, a, h, b, t, epochs, n_mb):
    """One PPO train step's matmuls, call by call: per collect step the
    actor and the critic on the obs, the critic on the final obs; the
    critic on the last obs; per minibatch the forward of both nets, then
    the backward: a weight gradient per layer, an input gradient per layer
    but the first (the obs need none)."""
    actor, critic = (o, *h, a), (o, *h, 1)
    calls = t * (_dense(b, actor) + 2 * _dense(b, critic)) + _dense(b, critic)
    rows = t * b // n_mb
    for _ in range(epochs * n_mb):
        for net in (actor, critic):
            fwd = _dense(rows, net)
            calls += fwd + fwd + fwd[1:]
    return sum(calls)


def _sac_flops(o, a, h, b, n, grad_steps, iterations, actor_collects):
    """SAC iterations' matmuls, call by call.  The actor: its tower, then
    the mean and log_std heads; the twin critics: one batched matmul per
    layer over both."""
    def actor(rows):
        return _dense(rows, (o, *h)) + 2 * [2 * rows * h[-1] * a]

    critic = [2 * f for f in _dense(n, (o + a, *h, 1))]
    update = actor(n) + critic  # the target
    update += critic + critic + critic[1:]  # the critics' loss: forward, weight and input gradients
    update += actor(n) + critic  # the actor loss
    update += critic + actor(n) + actor(n)[1:]  # its backward: the critics' input gradients, the actor's
    update += critic  # the critic loss as a metric
    return actor_collects * sum(actor(b)) + iterations * grad_steps * sum(update)


def _einsum_flops(env, b):
    """The plain SSL step's one wheel-transform matmul per env step on the
    CPU: (robots x envs, 4 wheels) x (4, 3)."""
    return 2 * env.n_robots * b * 4 * 3


@pytest.mark.parametrize("learner", ["ppo", "sac"])
def test_roofline_matmul_flops_on_the_cpu(learner, tmp_path):
    b, chain = 16, {"ppo": 1, "sac": 2}[learner]
    args = ["--device", "cpu", "--learner", learner, "--envs", str(b), "--chain", str(chain), "--fused",
            "--fused-rng", "kernel", "--out", str(tmp_path / "trace"), "--json", str(tmp_path / "r.json")]
    args += ["--rollout-steps", "2", "--num-minibatches", "2", "--num-epochs", "1"] if learner == "ppo" else [
        "--batch-size", "32"]
    out = roofline.main(args)
    assert json.load(open(tmp_path / "r.json"))["matmul_flops"] == out["matmul_flops"]
    env = rt.make("SSLStaticDefenders-v0")
    o, a, h = env.obs_size, env.action_size, (256, 256)
    if learner == "ppo":
        towers, env_steps = _ppo_flops(o, a, h, b, 2, 1, 2), 2
    else:  # 2 warm-up calls and this one: all 6 collects inside the 50 warmup collects
        towers, env_steps = _sac_flops(o, a, h, b, 32, 2, chain, 0), chain
    assert out["matmul_flops_towers"] == towers
    assert out["matmul_flops"] == towers + env_steps * _einsum_flops(env, b)
    assert out["events"] == "cpu" and out["timer"] == "host_clock" and out["card"] == "cpu"
    assert sum(v["ms"] for v in out["by_category"].values()) == pytest.approx(out["us_per_iter"] * chain / 1e3)
    assert os.path.isfile(out["trace"]) and out["trace"].startswith(str(tmp_path))


def test_sac_flops_with_the_actor_collecting():
    """Past the warmup the collect runs the actor on the B envs."""
    b, n = 16, 32
    benv = rt.make_vec("SSLStaticDefenders-v0", b, device="cpu", fused=True, fused_rng="kernel")
    trainer = SACTrainer(benv, SACConfig(buffer_size=1024, batch_size=n, warmup_steps=1, grad_steps_per_iter=2,
                                         n_step=4, hidden=(32, 32)))
    box = [trainer.init(0)]

    def one():
        box[0], _ = trainer.train_step(box[0], iteration_generator(0, box[0].iteration, "cpu"))

    one()
    got = _trace.profile(one, 2, None, "cpu", with_flops=True).matmul_flops
    o, a = benv.obs_size, benv.action_size
    want = _sac_flops(o, a, (32, 32), b, n, 2, 2, 2)
    assert bounds.sac_matmul_flops(o, a, (32, 32), b, n, 2, 2, 2) == want
    assert got == want + 2 * _einsum_flops(benv.env, b)


@pytest.mark.parametrize("tool", ["bench_all", "profile_step", "profile_ppo", "profile_sac", "sd_spawn_slice"])
def test_tool_main_on_the_cpu(tool, tmp_path, capsys):
    mod = importlib.import_module(f"rsoccer_tpu_torch.tools.{tool}")
    out_arg = ["--out", str(tmp_path / tool)]
    if tool == "bench_all":
        rows = mod.main(["--device", "cpu", "--envs", "16", "--ids", "VSS-v0,SSLPassEndurance-v0",
                         "--modes", "0,full-krng", "--steps", "3", "--iters", "1", "--min-seconds", "0",
                         "--out", str(tmp_path / "bench.json")])
        assert json.load(open(tmp_path / "bench.json")) == rows and len(rows) == 4
        assert all(r["timer"] == "host_clock" and r["card"] == "cpu" and r["value"] > 0 for r in rows)
        with pytest.raises(NotImplementedError, match="VSS envs only"):  # BatchedEnv's own error
            mod.main(["--device", "cpu", "--envs", "16", "--ids", "SSLDribbling-v0", "--modes", "1",
                      "--steps", "2", "--iters", "1", "--min-seconds", "0", "--out", str(tmp_path / "b1.json")])
        return
    if tool == "sd_spawn_slice":
        out = mod.main(["--device", "cpu", "--params", SD_PPO3, "--envs", "16", "--steps", "3", "--fused"])
        assert json.loads(capsys.readouterr().out) == out
        assert sorted(out["by_defender_dist"]) == sorted(mod.LABELS_D)
        with pytest.raises(ValueError, match="unfused path"):  # the fused kernels refuse a curriculum
            mod.main(["--device", "cpu", "--params", SD_PPO3, "--envs", "16", "--steps", "1", "--fused",
                      "--env-kwargs", '{"curriculum": true}'])
        return
    args = {
        "profile_step": ["--envs", "16", "--steps", "3", "--mode", "full-krng"],
        "profile_ppo": ["--envs", "16", "--rollout-steps", "2", "--hidden", "32,32", "--num-minibatches", "2",
                        "--num-epochs", "1", "--iters", "1", "--fused", "--fused-rng", "kernel"],
        "profile_sac": ["--envs", "16", "--batch-size", "32", "--chain", "2", "--iters", "1", "--fused"],
    }[tool]
    out = mod.main(["--device", "cpu", *args, *out_arg])
    trace = out if tool == "profile_step" else out["trace"]
    assert trace["events"] == "cpu" and trace["timer"] == "host_clock" and out["card"] == "cpu"
    assert tool == "profile_step" or out["timer"] == "host_clock"
    assert os.path.isfile(trace["trace"]) and trace["trace"].startswith(str(tmp_path))
    assert trace["top"] and 0 < trace["busy_share"] <= 1.0
