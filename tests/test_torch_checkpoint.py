"""The port's checkpoints (``rsoccer_tpu_torch/utils/checkpoint.py``,
``convert.py``) against the JAX package's: the PPO leaf table equals
``jax.tree.flatten`` of the reference's ``{params, obs_norm}``, files
cross both ways bit for bit, the shipped ``vss_ppo`` loads without jax and
acts as the JAX package's policy does, and a training state resumes bit
for bit."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu.batch.vecenv import BatchedEnv as JaxBatchedEnv
from rsoccer_tpu.models.ppo import PPOConfig as JaxPPOConfig
from rsoccer_tpu.models.ppo import PPOTrainer as JaxPPOTrainer
from rsoccer_tpu.utils import checkpoint as jax_ckpt
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch.models.ppo import ObsNorm, PPOConfig, PPOTrainer, make_policy
from rsoccer_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = {  # checkpoint: (obs, act), the layouts the table was checked on
    "vss_ppo": (40, 2), "cp_ppo2": (14, 5), "drb_ppo": (21, 4), "sd_ppo3": (24, 5),
}
# the PPO checkpoint's leaf table (convert.py), towers of 2 hidden layers
LEAF_TABLE = [
    "['obs_norm'].mean", "['obs_norm'].var", "['obs_norm'].count",
    *(f"['params']['params']['{name}']['{f}']"
      for name in ("actor_0", "actor_1", "actor_out", "critic_0", "critic_1", "critic_out")
      for f in ("bias", "kernel")),
    "['params']['params']['log_std']",
]


def ckpt_path(name):
    return os.path.join(REPO, "artifacts", f"{name}.ckpt.npz")


def jax_like(obs_size=40, act_size=2, hidden=(256, 256), seed=0):
    """The reference's ``{params, obs_norm}`` (examples/train_ppo_vss.py)
    with seeded random leaves, and its trainer."""
    env = rsoccer_tpu.make("VSS-v0")
    jtr = JaxPPOTrainer(JaxBatchedEnv(env, 8), JaxPPOConfig(hidden=hidden))
    state = jtr.init(jax.random.PRNGKey(seed))
    like = {"params": state.params, "obs_norm": state.obs_norm}
    rng = np.random.default_rng(seed)
    like = jax.tree.map(lambda x: jnp.asarray(np.asarray(x) + rng.normal(size=x.shape).astype(np.float32)), like)
    return like, jtr


def test_leaf_table_equals_jax_flatten():
    like, _ = jax_like()
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(like)[0]]
    assert paths == LEAF_TABLE
    net, obs_norm = convert.ppo_from_leaves([np.asarray(x) for x in jax.tree.leaves(like)], device="cpu")
    tree = convert.ppo_to_numpy(net, obs_norm)
    assert [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]] == LEAF_TABLE
    for got, want in zip(checkpoint.flatten(tree), jax.tree.leaves(like)):
        np.testing.assert_array_equal(got, np.asarray(want))
    # Linear.weight is the flax kernel transposed
    np.testing.assert_array_equal(net.actor[0].weight.detach().numpy(),
                                  np.asarray(like["params"]["params"]["actor_0"]["kernel"]).T)


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_ppo_checkpoints_fit_the_table(name):
    net, obs_norm = convert.load_ppo_checkpoint(ckpt_path(name), device="cpu")
    assert (net.obs_size, net.action_size, net.hidden) == (*SHIPPED[name], (256, 256))
    leaves = checkpoint.load_leaves(ckpt_path(name))
    for got, want in zip(checkpoint.flatten(convert.ppo_to_numpy(net, obs_norm)), leaves):
        np.testing.assert_array_equal(got, want)


def test_layout_mismatch_names_the_leaf():
    leaves = checkpoint.load_leaves(ckpt_path("vss_ppo"))
    bad = list(leaves)
    bad[6] = bad[6][:, :128]  # actor_1 kernel
    with pytest.raises(ValueError, match=r"leaf_6 \(actor_1.kernel\)"):
        convert.ppo_from_leaves(bad, device="cpu")
    with pytest.raises(ValueError, match="has 15"):
        convert.ppo_from_leaves(leaves[:15], device="cpu")


def test_port_save_jax_restore_and_back_exact(tmp_path):
    like, _ = jax_like(seed=1)
    net, obs_norm = convert.ppo_from_leaves([np.asarray(x) for x in jax.tree.leaves(like)], device="cpu")
    checkpoint.save(str(tmp_path / "port.ckpt"), convert.ppo_to_numpy(net, obs_norm))
    assert sorted(os.listdir(tmp_path)) == ["port.ckpt.npz"]  # no treedef pickle
    back = jax_ckpt.restore(str(tmp_path / "port.ckpt"), like=like)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(like)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    like2, _ = jax_like(seed=2)
    jax_ckpt.save(str(tmp_path / "jax.ckpt"), like2)
    net2, obs_norm2 = convert.load_ppo_checkpoint(str(tmp_path / "jax.ckpt"), device="cpu")
    port_like = convert.ppo_to_numpy(net2, obs_norm2)
    restored = checkpoint.restore(str(tmp_path / "jax.ckpt"), like=port_like)
    assert isinstance(restored["obs_norm"], ObsNorm)
    for got, want in zip(checkpoint.flatten(restored), jax.tree.leaves(like2)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_restore_into_tensors_keeps_structure(tmp_path):
    tree = {"b": [torch.arange(3.0), None, (torch.ones(2, 2),)], "a": ObsNorm(*torch.randn(3, 4)),
            "c": np.int64(7)}
    checkpoint.save(str(tmp_path / "t"), tree)
    back = checkpoint.restore(str(tmp_path / "t.npz"), like=tree)
    assert list(back) == ["b", "a", "c"] and back["b"][1] is None and isinstance(back["a"], ObsNorm)
    for got, want in zip(checkpoint.flatten(back), checkpoint.flatten(tree)):
        if isinstance(want, torch.Tensor):
            assert isinstance(got, torch.Tensor) and torch.equal(got, want)
        else:
            assert got == want
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(str(tmp_path / "t.npz"), like={"a": tree["a"]})


def test_vss_ppo_loads_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['rsoccer_tpu'] = None\n"
        "from rsoccer_tpu_torch import convert\n"
        f"net, on = convert.load_ppo_checkpoint({ckpt_path('vss_ppo')!r}, device='cpu')\n"
        "assert (net.obs_size, net.action_size, net.hidden) == (40, 2, (256, 256))\n"
        "print('ok', float(on.count))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")


def test_vss_ppo_policy_acts_as_jax_policy():
    """Deterministic actions of the shipped policy (bf16 towers) on 1024
    seeded obs: the port's against the JAX package's make_policy."""
    like, jtr = jax_like()
    ck = jax.tree.map(jnp.asarray, jax_ckpt.restore(ckpt_path("vss_ppo"), like=like))
    obs = np.random.default_rng(3).uniform(-1.2, 1.2, (40, 1024)).astype(np.float32)
    j_policy = jtr.make_policy(ck["params"], ck["obs_norm"], deterministic=True)
    j_act = np.asarray(j_policy(jax.random.PRNGKey(0), jnp.asarray(obs)))
    net, obs_norm = convert.load_ppo_checkpoint(ckpt_path("vss_ppo"), device="cpu")
    t_act = make_policy(net, obs_norm, deterministic=True)(None, torch.from_numpy(obs)).numpy()
    assert t_act.shape == (2, 1024) and np.abs(t_act).max() <= 1.0
    # the bf16 forward's tolerance (test_torch_ppo.py); the same towers in
    # f32 move these actions by up to ~0.26
    np.testing.assert_allclose(t_act, j_act, rtol=0, atol=1e-3)


def test_train_state_resumes_bit_for_bit(tmp_path):
    trainer = PPOTrainer(rsoccer_tpu_torch.make_vec("VSS-v0", 16, device="cpu", fused=True, fused_rng="kernel"),
                         PPOConfig(rollout_steps=8, hidden=(32, 32), num_epochs=2, num_minibatches=2))
    state, _ = trainer.train_step(trainer.init(0))
    path = str(tmp_path / "resume")
    checkpoint.save(path, trainer.state_tree(state))
    back = trainer.state_from_tree(checkpoint.restore(path, like=trainer.state_tree(trainer.init(5))))
    for a, b in zip(state.net.parameters(), back.net.parameters()):
        assert torch.equal(a, b)
    assert back.update_step == state.update_step == 1
    s1, m1 = trainer.train_step(state)
    s2, m2 = trainer.train_step(back)
    for a, b in zip(s1.net.parameters(), s2.net.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(s1.env_state, s2.env_state) and torch.equal(s1.env_key, s2.env_key)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


def test_train_script_writes_a_checkpoint_jax_reads(tmp_path):
    from rsoccer_tpu_torch.examples import train_ppo_vss

    path = str(tmp_path / "run.ckpt")
    train_ppo_vss.main(["--device", "cpu", "--envs", "16", "--updates", "2", "--rollout-steps", "8",
                        "--hidden", "32,32", "--num-minibatches", "2", "--fused", "--fused-rng", "kernel",
                        "--save", path])
    like, _ = jax_like(hidden=(32, 32))
    back = jax_ckpt.restore(path + ".npz", like=like)
    assert float(back["obs_norm"].count) == pytest.approx(1e-4 + 2 * 8 * 16)
    # and warm-starts the port
    train_ppo_vss.main(["--device", "cpu", "--envs", "16", "--updates", "1", "--rollout-steps", "8",
                        "--hidden", "32,32", "--num-minibatches", "2", "--init", path + ".npz",
                        "--freeze-obs-norm", "--critic-warmup", "1"])
