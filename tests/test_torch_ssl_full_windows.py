"""The fused SSLDribbling-v0 and SSLPassEndurance-v0 plain versions vs the
JAX package's Pallas kernels (interpret mode) on windows built to reach
every branch: the Dribbling gate automaton, PassEndurance's received
passes, stopped balls and balls leaving the shooter-receiver box.

The lanes are built by ``chip_smoke.py``'s own builders, so the card's
checks and these start from the same kind of state.  Each step is held lane
by lane (``dribbler_face_lanes``): where the JAX kernel's dribbler-face
order departs from the JAX XLA env, the port is held to the XLA env.  Run
with ``-s`` to see how many such lanes each window holds."""

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from rsoccer_tpu.ops import pallas_ssl_full as jpsf
from rsoccer_tpu_torch.batch.vecenv import BatchedEnv
from rsoccer_tpu_torch.ops import philox
from rsoccer_tpu_torch.ops import ssl_full as sf
from tests.test_torch_ssl_full import DR, PE, dribbler_face_lanes, np_rows, pair

torch.set_num_threads(1)

W = 64  # lanes per window


def built_window(tenv, build):
    st = BatchedEnv(tenv, W, device="cpu", fused=True).reset(philox.make_key(2, device="cpu"))[0]
    return build(st, share=1.0)


def run_window(env_id, jmake, plain, build, actions, events, n_steps):
    """``n_steps`` steps from built lanes, the port and the JAX kernel from
    the same state each step.  Returns (events summed, face lanes per step,
    kind per lane)."""
    jenv, tenv = pair(env_id)
    jstep = jmake(jenv, W, tile=W, interpret=True)
    st, kinds = built_window(tenv, build)
    rng = np.random.default_rng(5)
    total, face = {}, []
    for t in range(n_steps):
        act = actions(tenv)
        rows = np_rows(rng, env_id, tenv, W)
        want = jstep(jnp.asarray(st.numpy()), jnp.asarray(act.numpy()),
                     *(jnp.asarray(r.numpy()) for r in rows))
        got = plain(tenv, st, act, *rows)
        face.append(dribbler_face_lanes(env_id, jenv, tenv, st, act, rows, False, got, want,
                                        f"step {t}").tolist())
        for k, v in events(kinds, st, got, t).items():
            total[k] = total.get(k, 0) + v
        st = got[0]
    return total, face, kinds.numpy()


def test_dr_gate_window_matches_jax_kernel():
    """Lanes on every branch of the gate automaton (cross0, cross1,
    cross_even, reverse_even, cross_odd, completed, rbt_out, collision), the
    robot dribbling: each branch goes its way, as the JAX kernel's does."""

    def dribble(tenv):
        act = torch.zeros((tenv.action_size, W))
        act[3] = 1.0
        return act

    ev, face, kinds = run_window(DR, jpsf.make_pallas_dr_full_step, sf.dr_full_step_plain,
                                 chip_smoke.dr_gate_states, dribble, chip_smoke.dr_events, 3)
    print(f"\nDR window: {ev}, dribbler-face lanes per step {face}")
    for k, name in enumerate(chip_smoke.DR_KINDS):
        assert ev[f"built_{name}"] == (kinds == k).sum() > 0, (name, ev)
    assert ev["crossings"] >= 5 * (kinds == 0).sum() and ev["completions"] == (kinds == 5).sum()


def test_pe_pass_window_matches_jax_kernel():
    """Balls rolling onto the receiver's kicker face, stopped balls with
    the counter at 20, balls leaving the box, balls grazing the face's
    lateral edge: passes are received, both wrong-ball tests fire, and the
    dribbler-face lanes are found, all of them grazing lanes."""

    def still(tenv):
        return torch.zeros((tenv.action_size, W))

    ev, face, kinds = run_window(PE, jpsf.make_pallas_pe_full_step, sf.pe_full_step_plain,
                                 chip_smoke.pe_pass_states, still, chip_smoke.pe_events, 8)
    lanes = sorted({lane for step in face for lane in step})
    print(f"\nPE window: {ev}, dribbler-face lanes per step {face} ({len(lanes)} lanes)")
    assert ev["received"] >= (kinds == 0).sum() // 2
    assert ev["built_stopped_wrong"] == (kinds == 1).sum() and ev["built_out_wrong"] == (kinds == 2).sum()
    edge = chip_smoke.PE_KINDS.index("edge")
    assert lanes and all(kinds[lane] == edge for lane in lanes)
