"""The frozen reference equals ``rsoccer_tpu_torch``'s plain step at 64
envs, and its copy of the packed row layout the program's unpacking, bit
for bit on the CPU: the one place where a test imports both."""

import pytest
import torch

from benchmark.harness import compare
from benchmark.reference import envstep, layout
from benchmark.reference.ops import philox as ref_philox

CASES = [("VSS-v0", {"field_type": 0, "n_robots_blue": 3, "n_robots_yellow": 3, "time_step": 0.025}),
         ("SSLStaticDefenders-v0", {"field_type": 2, "time_step": 0.025})]


@pytest.mark.parametrize("env_id,kwargs", CASES)
def test_reference_equals_plain_step(env_id, kwargs):
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.ops.philox import make_key

    torch.manual_seed(0)
    n = 64
    benv = rt.make_vec(env_id, n, device="cpu", **kwargs)
    ref_env = envstep.make(env_id, **kwargs)
    key = make_key(2**31 + 5, stream=0, device="cpu")
    assert torch.equal(key, ref_philox.make_key(2**31 + 5, stream=0, device="cpu"))
    want_st, want_obs = envstep.reset(ref_env, key, n)
    state, obs = benv.reset(key)
    assert torch.equal(obs, want_obs)
    ref_types = {type(x).__name__: type(x) for x in (want_st, want_st.world, want_st.world.ball,
                                                       want_st.world.robots)}
    for _ in range(40):
        act = torch.rand((benv.action_size, n)) * 2 - 1
        s_ref = compare.rebuild(state, ref_types, lambda t: t)
        w_st, w_obs, w_rew, w_term, w_trunc, _ = envstep.step(ref_env, s_ref, act, key)
        state, obs, rew, term, trunc, _ = benv.step(state, act, key)
        got, want = compare.flatten(state), compare.flatten(w_st)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(obs, w_obs) and torch.equal(rew, w_rew)
        assert torch.equal(term, w_term) and torch.equal(trunc, w_trunc)


@pytest.mark.parametrize("env_id,kwargs", CASES)
def test_layout_equals_program_unpacking(env_id, kwargs):
    import rsoccer_tpu_torch as rt
    from rsoccer_tpu_torch.ops.philox import make_key

    torch.manual_seed(1)
    n = 64
    benv = rt.make_vec(env_id, n, device="cpu", fused=True, fused_rng="kernel", **kwargs)
    ref_env = envstep.make(env_id, **kwargs)
    key = make_key(2**31 + 6, stream=0, device="cpu")
    state, _ = benv.reset(key)
    assert state.shape[0] == layout.rows(ref_env)
    for _ in range(30):
        got, want = compare.flatten(layout.unpack(ref_env, state)), compare.flatten(benv.unpack_state(state))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        state, *_ = benv.step(state, torch.rand((benv.action_size, n)) * 2 - 1, key)
