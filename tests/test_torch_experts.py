"""The port's scripted experts (``rsoccer_tpu_torch/experts.py``) held
against the JAX package's on the CPU, and their completion tests.

States come from numpy-seeded resets, short unfused JAX rollouts (the
expert acting, every other lane with seeded action noise) and worlds
built next to the experts' gates, carried across with
``convert.state_from_numpy``.  Each expert's gate quantities (the signed
margins of the strict comparisons it branches on) are held to a
restatement of the JAX expert's within 1e-6; its actions within 1e-5 on
every lane whose margins all exceed 1e-5; the lanes left out (on a
threshold, where XLA's ``hypot``/``atan2``/``softmax`` and torch's may
round to different sides) are counted and must be few.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsoccer_tpu
import rsoccer_tpu_torch
from rsoccer_tpu import experts as jexp
from rsoccer_tpu.envs.base import strongify
from rsoccer_tpu_torch import convert
from rsoccer_tpu_torch import experts as texp
from rsoccer_tpu_torch.envs.ssl_dribbling import DribblingState
from rsoccer_tpu_torch.envs.ssl_pass_endurance import PEState
from rsoccer_tpu_torch.envs.ssl_static_defenders import SDState
from rsoccer_tpu_torch.ops import ssl_full as sf
from rsoccer_tpu_torch.ops.philox import make_key
from tests.test_torch_env_ssl import jx, np_noise, vm

torch.set_num_threads(1)

DR, SD, PE = "SSLDribbling-v0", "SSLStaticDefenders-v0", "SSLPassEndurance-v0"
IDS = [DR, SD, PE]
STATE_CLS = {DR: DribblingState, SD: SDState, PE: PEState}
PACK = {DR: sf.pack_dr_state, SD: sf.pack_sd_state, PE: sf.pack_pe_state}
UNPACK = {DR: sf.unpack_dr_state, SD: sf.unpack_sd_state, PE: sf.unpack_pe_state}
B = 64
SNAPSHOTS = (0, 8, 30, 80)  # rollout steps whose states are compared
GATE_ATOL = 1e-6
ACT_ATOL = 1e-5
ON_GATE = 1e-5  # a lane with a margin this close to 0 may flip between packages
MAX_ON_GATE = 3


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def reset_noise(env, rng, b):
    spec = env.reset_noise_spec()
    return np_noise(rng, spec, b) if spec else {"_pad": np.zeros((1, b), np.float32)}


def jax_expert(env_id, env):
    if env_id == SD:
        return lambda s: jexp.static_defenders_expert(s, field=env.field)
    return {DR: jexp.dribbling_expert, PE: jexp.pass_endurance_expert}[env_id]


def port_terms(env_id, env):
    """The port's expert as ``state -> (action, gates)``."""
    if env_id == SD:
        return lambda s: texp._static_defenders(s, env.field)
    return {DR: texp._dribbling, PE: texp._pass_endurance}[env_id]


# ------------------------------------------------- the JAX gates, restated
# (rsoccer_tpu/experts.py, one env each; vmapped over the trailing batch)

def _jwrap(a):
    return (a + jnp.pi) % (2 * jnp.pi) - jnp.pi


def _jseam(a):
    return jnp.pi - jnp.abs(a)


def jax_dr_gates(state):  # experts.py:58-88
    rb = state.world.robots
    rx, ry, theta = rb.x[0], rb.y[0], rb.theta[0]
    bx, by = state.world.ball.x, state.world.ball.y
    gx, w_lo, w_hi, downward = jexp.dribbling_gate(state.checkpoints)
    sign = jnp.where(downward, 1.0, -1.0)
    lane_y = sign * 0.35
    fx, fy = rx + jexp._FACE * jnp.cos(theta), ry + jexp._FACE * jnp.sin(theta)
    has_ball = jnp.hypot(fx - bx, fy - by) < 0.05
    on_lane = jnp.abs(by - lane_y) < 0.08
    nav_x = jnp.where(has_ball, jnp.where(on_lane, gx, bx), bx)
    nav_y = jnp.where(has_ball, lane_y, by)
    return {
        "has_ball": 0.05 - jnp.hypot(fx - bx, fy - by),
        "zone_lo": rx - (w_lo + 0.15), "zone_hi": (w_hi - 0.15) - rx,
        "committed": (0.35 - 0.12) - sign * by,
        "window_lo": rx - w_lo, "window_hi": w_hi - rx,
        "on_lane": 0.08 - jnp.abs(by - lane_y),
        "near": 0.45 - jnp.abs(rx - gx),
        "dive_seam": _jseam(_jwrap(-sign * (jnp.pi / 2) - theta)),
        "cruise_seam": _jseam(_jwrap(jnp.arctan2(nav_y - ry, nav_x - rx) - theta)),
    }


def jax_sd_gates(field):  # experts.py:165-305, default arguments
    def gates(state):
        f = field
        rb = state.world.robots
        rx, ry, theta, w = rb.x[0], rb.y[0], rb.theta[0], rb.v_theta[0]
        bx, by = state.world.ball.x, state.world.ball.y
        dx, dy = rb.x[1:], rb.y[1:]
        half_goal = f.goal_width / 2
        ty = jnp.linspace(-0.8, 0.8, 9) * half_goal
        gx = f.half_length + 0.02
        sx_ = jnp.full_like(ty, gx - bx)
        sy_ = ty - by
        seg_len2 = jnp.maximum(sx_**2 + sy_**2, 1e-6)
        t = ((dx[None, :] - bx) * sx_[:, None] + (dy[None, :] - by) * sy_[:, None]) / seg_len2[:, None]
        t = jnp.clip(t, 0.0, 1.0)
        clr = jnp.min(jnp.hypot(dx[None, :] - (bx + t * sx_[:, None]),
                                dy[None, :] - (by + t * sy_[:, None])), axis=1)
        score = clr - 0.02 * jnp.abs(ty) / jnp.maximum(half_goal, 1e-6)
        aim_y = jnp.sum(jax.nn.softmax(score / 0.08) * ty)
        shot_dir = jnp.arctan2(aim_y - by, gx - bx)
        c_dir, s_dir = jnp.cos(shot_dir), jnp.sin(shot_dir)
        pre_x, pre_y = bx - 0.14 * c_dir, by - 0.14 * s_dir
        gk_limit = f.half_length - f.penalty_length - 0.15
        band_hi = f.penalty_width / 2 + 0.12
        hx, hy = jnp.cos(theta), jnp.sin(theta)
        reach = (f.half_length - bx) / jnp.maximum(hx, 0.05)
        t_ray = jnp.clip(((dx - bx) * hx + (dy - by) * hy), 0.0, jnp.maximum(reach, 0.0))
        ray_clear = jnp.min(jnp.hypot(dx - (bx + t_ray * hx), dy - (by + t_ray * hy)))
        return {
            "behind_near": 0.12 - jnp.hypot(rx - pre_x, ry - pre_y),
            "behind_along": -0.05 - ((rx - bx) * c_dir + (ry - by) * s_dir),
            "gk_band": band_hi - jnp.abs(ry), "deep": rx - gk_limit,
            "margin_y": jnp.abs(ry) - (f.half_width - 0.15),
            "kick_hx": hx - 0.2, "kick_mouth": (half_goal - 0.06) - jnp.abs(by + hy * reach),
            "kick_w": 0.5 - jnp.abs(w), "kick_ray": ray_clear - 0.16,
            "aim_seam": _jseam(_jwrap(shot_dir - theta)),
            "fetch_seam": _jseam(_jwrap(jnp.arctan2(by - ry, bx - rx) - theta)),
        }

    return gates


def jax_pe_gates(state):  # experts.py:332-351
    rb = state.world.robots
    sx, sy, theta, w = rb.x[0], rb.y[0], rb.theta[0], rb.v_theta[0]
    rx, ry = rb.x[1], rb.y[1]
    err = _jwrap(jnp.arctan2(ry - sy, rx - sx) - theta)
    tol = jnp.clip(0.015 / jnp.maximum(jnp.hypot(rx - sx, ry - sy), 0.25), 0.006, 0.05)
    return {"ready_aim": tol - jnp.abs(err - w * 0.0125), "ready_w": 0.3 - jnp.abs(w),
            "aim_seam": _jseam(err)}


def jax_gates(env_id, env):
    return {DR: jax_dr_gates, SD: jax_sd_gates(env.field), PE: jax_pe_gates}[env_id]


# ------------------------------------------------------------------ states

def rollout_states(env_id, rng, b=B):
    """Numpy-seeded resets stepped by the JAX expert (odd lanes with seeded
    action noise) through the unfused transition, each lane frozen once it
    terminates; the states at SNAPSHOTS, concatenated along the batch."""
    # DR's reference reset draws nothing: its curriculum resets spread the lanes
    jenv = rsoccer_tpu.make(env_id, curriculum=env_id == DR)
    expert = vm(jax_expert(env_id, jenv))
    s0 = strongify(vm(jenv.reset_state)(jx(reset_noise(jenv, rng, b))))
    n = max(SNAPSHOTS)
    a_noise = (rng.uniform(-0.6, 0.6, (n, jenv.action_size, b)) * (np.arange(b) % 2)).astype(np.float32)

    @jax.jit
    def run(s, a_noise):
        def body(carry, an):
            st, done = carry
            act = jnp.clip(expert(st) + an, -1.0, 1.0)
            ns, _, term, _ = vm(jenv.transition)(st, act, {})
            out = jax.tree.map(lambda a, c: jnp.where(done, a, c), st, ns)
            return (out, done | term), out

        return jax.lax.scan(body, (s, jnp.zeros(b, bool)), a_noise)[1]

    traj = run(s0, jnp.asarray(a_noise))
    snaps = [s0] + [jax.tree.map(lambda x, t=t: x[t - 1], traj) for t in SNAPSHOTS[1:]]
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, -1), *snaps)


def gate_states(env_id, rng, b=B):
    """Worlds built next to the gates: each lane sits 0.5-20 mm from a
    threshold (never on it)."""
    jenv = rsoccer_tpu.make(env_id)
    s = np_tree(strongify(vm(jenv.reset_state)(jx(reset_noise(jenv, rng, b)))))
    w, rb = s.world, s.world.robots
    x, y, th, vth = (a.copy() for a in (rb.x, rb.y, rb.theta, rb.v_theta))
    ir, bx, by = rb.infrared.copy(), w.ball.x.copy(), w.ball.y.copy()
    off = (rng.choice([-1.0, 1.0], b) * rng.uniform(5e-4, 0.02, b)).astype(np.float32)
    f = jenv.field
    checkpoints = None
    if env_id == SD:
        gk_limit = f.half_length - f.penalty_length - 0.15
        band_hi = f.penalty_width / 2 + 0.12
        q = b // 4
        x[0, :q], y[0, :q] = gk_limit + off[:q], band_hi + rng.uniform(-0.3, 0.05, q)  # GK band, x
        x[0, q:2 * q] = gk_limit + rng.uniform(0.01, 0.3, q)
        y[0, q:2 * q] = np.sign(off[q:2 * q]) * (band_hi + np.abs(off[q:2 * q]))  # side entry
        y[0, 2 * q:3 * q] = np.sign(off[2 * q:3 * q]) * (f.half_width - 0.15) + off[2 * q:3 * q]
        x[0, 2 * q:3 * q] = rng.uniform(0.5, 3.0, q)
        # the kick gates: ball on the face, heading near the mouth's edge or
        # the heading limit, spin near w_tol
        k = np.arange(3 * q, b)
        n_k = len(k)
        x[0, k], y[0, k] = rng.uniform(2.0, 3.5, n_k), rng.uniform(-0.5, 0.5, n_k)
        th[0, k] = rng.choice([1.0, -1.0], n_k) * (np.arccos(0.2) + off[k])
        th[0, k[::2]] = np.arctan2(f.goal_width / 2 - 0.06 - y[0, k[::2]] + 2 * off[k[::2]],
                                   f.half_length - x[0, k[::2]])
        vth[0, k] = rng.choice([1.0, -1.0], n_k) * (0.5 + off[k])
        ir[0, k] = True
        bx[k] = x[0, k] + 0.11 * np.cos(th[0, k])
        by[k] = y[0, k] + 0.11 * np.sin(th[0, k])
    elif env_id == PE:
        dist = np.hypot(x[1] - x[0], y[1] - y[0])
        aim = np.arctan2(y[1] - y[0], x[1] - x[0])
        tol = np.clip(0.015 / np.maximum(dist, 0.25), 0.006, 0.05)
        vth[0] = rng.uniform(-0.25, 0.25, b)
        vth[0, ::4] = np.sign(off[::4]) * 0.3 + off[::4]  # the spin gate
        th[0] = aim - vth[0] * 0.0125 + rng.choice([1.0, -1.0], b) * (tol + off)  # the aim gate
        ir[0] = rng.uniform(size=b) < 0.75
    else:  # DR: the ball near the face-hold radius, the robot near the windows
        count = rng.integers(0, 8, b).astype(np.int32)
        gx, w_lo, w_hi, _ = (np.asarray(v) for v in vm(jexp.dribbling_gate)(jnp.asarray(count)))
        edge = np.where(rng.uniform(size=b) < 0.5, w_lo + 0.15, w_hi - 0.15)
        edge = np.where(rng.uniform(size=b) < 0.3, gx + np.sign(off) * 0.45, edge)
        x[0], y[0] = edge + off, rng.uniform(-0.45, 0.45, b)
        th[0] = rng.uniform(-math.pi, math.pi, b)
        r = texp._FACE + rng.choice([-1.0, 1.0], b) * rng.uniform(0.03, 0.07, b)
        r[::2] = texp._FACE + 0.05 + off[::2]
        bx, by = x[0] + r * np.cos(th[0]), y[0] + r * np.sin(th[0])
        checkpoints = count
    robots = rb._replace(x=x, y=y, theta=th.astype(np.float32), v_theta=vth.astype(np.float32),
                         infrared=ir)
    ball = w.ball._replace(x=bx.astype(np.float32), y=by.astype(np.float32))
    s = s._replace(world=w._replace(ball=ball, robots=robots))
    if checkpoints is not None:
        s = s._replace(checkpoints=checkpoints)
    return jax.tree.map(jnp.asarray, s)


# ----------------------------------------------------------------- tests

def test_aim_constants_equal_jax():
    """SD's candidate aims: the default nine are jnp.linspace's f32 values
    bit for bit; other counts within an ulp of 0.8."""
    np.testing.assert_array_equal(texp._aims(9).view(np.int32),
                                  np.asarray(jnp.linspace(-0.8, 0.8, 9)).view(np.int32))
    for n in (2, 5, 7, 17):
        np.testing.assert_allclose(texp._aims(n), np.asarray(jnp.linspace(-0.8, 0.8, n)), rtol=0,
                                   atol=float(np.spacing(np.float32(0.8))))


def test_dribbling_gate_equals_jax():
    count = np.arange(8, dtype=np.int32)
    want = [np.asarray(v) for v in vm(jexp.dribbling_gate)(jnp.asarray(count))]
    got = [v.numpy() for v in texp.dribbling_gate(torch.from_numpy(count))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_wrap_is_floor_mod():
    a = torch.tensor([-7.0, -3.2, -math.pi, 0.0, 3.1, math.pi, 4.0, 10.0])
    want = np.asarray(jexp._wrap(jnp.asarray(a.numpy())))
    np.testing.assert_allclose(texp._wrap(a).numpy(), want, rtol=0, atol=1e-6)
    assert bool((texp._wrap(a) >= -math.pi).all()) and bool((texp._wrap(a) < math.pi).all())


@pytest.mark.parametrize("source", ["rollout", "gates"])
@pytest.mark.parametrize("env_id", IDS)
def test_expert_matches_jax(env_id, source):
    rng = np.random.default_rng({DR: 0, SD: 1, PE: 2}[env_id] + (10 if source == "gates" else 0))
    js = (rollout_states if source == "rollout" else gate_states)(env_id, rng)
    jenv, tenv = rsoccer_tpu.make(env_id), rsoccer_tpu_torch.make(env_id)
    ja = np.asarray(vm(jax_expert(env_id, jenv))(js))
    jg = {k: np.asarray(v) for k, v in vm(jax_gates(env_id, jenv))(js).items()}
    ts = convert.state_from_numpy(np_tree(js), STATE_CLS[env_id], device="cpu")
    ta, tg = port_terms(env_id, tenv)(ts)
    assert ta.shape == ja.shape and ta.dtype == torch.float32
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), jg[k], rtol=0, atol=GATE_ATOL, err_msg=k)
    clear = np.all([np.abs(v) > ON_GATE for v in jg.values()], axis=0)
    on_gate = int((~clear).sum())
    print(f"{env_id} {source}: {ja.shape[1]} lanes, {on_gate} on a gate")
    assert on_gate <= MAX_ON_GATE, f"{on_gate} lanes within {ON_GATE} of a gate"
    np.testing.assert_allclose(ta.numpy()[:, clear], ja[:, clear], rtol=0, atol=ACT_ATOL)
    np.testing.assert_array_equal(texp.EXPERTS[env_id](tenv)(ts).numpy(), ta.numpy())


@pytest.mark.parametrize("env_id", IDS)
def test_expert_on_the_packed_state(env_id):
    """The fused path's view of a state (``unpack(pack(state))``, infrared
    recomputed from the kicker face) gives the same actions as the
    unfused rollout's state, whose infrared the physics set.  The flags
    themselves agree on every SD and PE lane; DR's reset sets infrared
    False where the face predicate holds (as in the JAX package), which
    its expert does not read."""
    benv = rsoccer_tpu_torch.make_vec(env_id, 32, device="cpu")
    expert = texp.EXPERTS[env_id](benv.env)
    key = make_key(4, device="cpu")
    state, _ = benv.reset(key)
    differ = 0
    for t in range(40):
        act = expert(state)
        view = UNPACK[env_id](PACK[env_id](state), benv.env)
        torch.testing.assert_close(expert(view), act, rtol=0, atol=0)
        differ += int((view.world.robots.infrared != state.world.robots.infrared).sum())
        if env_id != DR:
            assert differ == 0, f"step {t}"
        state, *_ = benv.step(state, act, key)
    assert env_id != DR or differ == 32  # robot 0 on the reset step, every lane


def test_dribbling_expert_completes_reference_course():
    """tests/test_experts.py's course on the port: completed within 1200
    steps, clearance to every yellow above the 0.18 m contact radius."""
    env = rsoccer_tpu_torch.make(DR)
    st = env.reset_state({"_pad": torch.zeros((1, 1))})
    mind, completed, steps = 9.9, False, 0
    for _ in range(1200):
        st, _, term, _ = env.transition(st, texp.dribbling_expert(st), {})
        rb = st.world.robots
        mind = min(mind, float(torch.hypot(rb.x[0] - rb.x[1:], rb.y[0] - rb.y[1:]).min()))
        steps = int(st.steps[0])
        if bool(term[0]):
            completed = int(st.checkpoints[0]) == 7
            break
    print(f"DR reference course: completed={completed} in {steps} steps, clearance {mind:.4f} m")
    assert completed and steps < 1200
    assert mind > 0.18


def test_pass_endurance_expert_success():
    """Aim-and-kick completes the pass on >= 97% of 128 reference resets
    within 400 steps (tests/test_experts.py's floor)."""
    env = rsoccer_tpu_torch.make(PE)
    b = 128
    key = make_key(3, device="cpu")
    from rsoccer_tpu_torch.envs.base import draw_noise, select

    st = env.reset_state(draw_noise(key, env.reset_noise_spec(), b))
    done = torch.zeros(b, dtype=torch.bool)
    success = torch.zeros(b, dtype=torch.bool)
    for _ in range(400):
        ns, r, term, _ = env.transition(st, texp.pass_endurance_expert(st), {})
        success |= term & (r > 0.5) & ~done
        st = select(done, st, ns)
        done |= term
        if bool(done.all()):
            break
    assert int(success.sum()) >= int(0.97 * b), int(success.sum())


def test_static_defenders_expert_scores_most_episodes():
    """The SD expert on the fused path (its plain version here), reading
    the packed state through unpack_state: >= 88% goals over >= 200
    episodes, and never into the GK area (tests/test_experts.py's floors)."""
    benv = rsoccer_tpu_torch.make_vec(SD, 64, device="cpu", fused=True, fused_rng="kernel")
    expert = texp.EXPERTS[SD](benv.env)
    key = make_key(3, device="cpu")
    st, _ = benv.reset(key)
    d = w = g = 0.0
    for _ in range(700):
        st, _, r, term, trunc, info = benv.step(st, expert(benv.unpack_state(st)), key)
        done = term | trunc
        d += float(done.sum())
        w += float((done & (r >= 4.5)).sum())
        g += float((done * info["rbt_in_gk_area"]).sum())
    assert d >= 200, f"too few episodes finished ({d})"
    assert w / d >= 0.88, f"expert goal rate {w / d:.3f} below floor"
    assert g == 0, f"expert entered the GK area {g} times"


def test_default_device_is_the_card():
    """Without a card the expert path's defaults raise: the env on 'cuda'
    refuses to reset, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    benv = rsoccer_tpu_torch.make_vec(PE, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benv.reset(make_key(0, device="cpu"))
