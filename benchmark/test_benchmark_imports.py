"""After a CPU run of each driver no module of ``jax``, ``jaxlib``,
``flax`` or the JAX package is loaded (top-level names compared whole), and
the reference alone loads nothing of ``rsoccer_tpu_torch``."""

import subprocess
import sys

from benchmark.harness.manifest import ROOT
from benchmark.run import forbidden_modules

DRIVERS = """
import sys, torch
torch.set_num_threads(1)
from benchmark import run as R
ctx = R.context("vss-3v3.rollout-1048576", 3, 1.0, False, torch.device("cpu"))
ctx.traffic.update(n_envs=16, steps_per_call=2, check_block=16)
R.execute(ctx)
ctx = R.context("ssl-sd.rollout-2097152", 3, 1.0, False, torch.device("cpu"))
ctx.traffic.update(n_envs=16, steps_per_call=2, check_block=16)
R.execute(ctx)
print(",".join(R.forbidden_modules()) or "none")
print("rsoccer_tpu_torch" in {m.split(".")[0] for m in sys.modules})
"""

REFERENCE = """
import sys, torch
from benchmark.reference import envstep, layout
from benchmark.reference.ops.philox import make_key
env = envstep.make("VSS-v0")
st, obs = envstep.reset(env, make_key(1, device="cpu"), 8)
envstep.step(env, st, torch.zeros(2, 8), make_key(1, device="cpu"))
print(sorted({m.split(".")[0] for m in sys.modules} & {"rsoccer_tpu_torch", "rsoccer_tpu", "jax", "jaxlib", "flax"}))
"""


def _run(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_forbidden_names_are_whole_words():
    sys.modules.setdefault("rsoccer_tpu_torch_lookalike", sys)
    try:
        assert "rsoccer_tpu" not in forbidden_modules()
    finally:
        del sys.modules["rsoccer_tpu_torch_lookalike"]


def test_drivers_load_no_jax():
    lines = _run(DRIVERS)
    assert lines[-2] == "none" and lines[-1] == "True"


def test_reference_loads_nothing_of_the_program():
    assert _run(REFERENCE)[-1] == "[]"
