"""Crash and resume is lossless on the port (``tests/test_elastic.py``'s
counterpart): ``rsoccer_tpu_torch/tools/elastic_train.py`` on the CPU,
run uninterrupted, crashed by a real process exit before update 5 (the
snapshot of update 3 survives), and resumed; the resumed run ends with
the uninterrupted run's state digest and its ``.meta.json`` at the last
update.  PPO and SAC, the unfused and the fused (plain) path."""

import json

import pytest

from tests.torch_dist_worker import spawn

TIMEOUT = 120  # seconds, each run


def start(extra):
    return spawn([["rsoccer_tpu_torch.tools.elastic_train", "--device", "cpu", *extra]], TIMEOUT)


def finish(wait, want_rc=0):
    ((rc, out, err),) = wait()
    assert rc == want_rc, err[-3000:]
    return out, err


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_crash_resume_bit_identical(tmp_path, algo, fused):
    ck_a, ck_b = str(tmp_path / "uninterrupted"), str(tmp_path / "crashy")
    common = ["--updates", "9", "--every", "3", "--envs", "16", "--algo", algo, *(["--fused"] if fused else [])]
    straight = start(["--ckpt", ck_a, *common])
    crashed = start(["--ckpt", ck_b, *common, "--crash-at", "5"])
    ref = json.loads(finish(straight)[0].strip().splitlines()[-1])
    _, err = finish(crashed, want_rc=1)
    assert "simulated crash before update 5" in err
    # the snapshot of update 3 survives the crash
    with open(ck_b + ".meta.json") as f:
        assert json.load(f)["update"] == 3

    got = json.loads(finish(start(["--ckpt", ck_b, *common, "--resume"]))[0].strip().splitlines()[-1])
    assert got["update"] == ref["update"] == 9
    assert got["digest"] == ref["digest"]
    assert got["mean_reward"] == ref["mean_reward"]
    for ck in (ck_a, ck_b):
        with open(ck + ".meta.json") as f:
            assert json.load(f)["update"] == 9
