// Fused SSL env steps, one env per thread: SSLStaticDefenders-v0 (N = 7),
// SSLContestedPossession-v0 (N = 2), SSLDribbling-v0 (N = 5) and
// SSLPassEndurance-v0 (N = 2).
//
// Replaces the TPU kernels rsoccer_tpu/ops/pallas_ssl_full.py:456
// (make_pallas_sd_full_step), :824 (make_pallas_cp_full_step), :1086
// (make_pallas_dr_full_step) and :1327 (make_pallas_pe_full_step), and
// their shared launch _build_call (:289).  Per env: action conversion ->
// the SSL world step (ssl_body.cuh) -> the task's termination and reward
// (SD/CP: the reference's termination chain and shaping; DR: the gate
// automaton; PE: pass received, wrong ball, stopped counter) -> on done
// lanes only, the reset (SD: first-valid ball and six separated defenders;
// CP: the enemy in the penalty strip; DR: the fixed course; PE: ball,
// shooter and the first receiver candidate 1 m away) -> auto-reset select
// -> observation.
//
// Layout: every operand is a flat row-major (rows, B) f32 array read as
// p[row * B + b], so each row load is coalesced (the TPU kernels' (S, B)
// state layout byte for byte).
//
// What bounds it: at B = 8192 an SD step moves ~5 MB (state in/out, action,
// obs, aux), about 1.5 us of HBM time, while each thread runs a long
// dependent scalar chain (5 substeps x (21 robot pairs + 7 ball contacts))
// and 8192 threads are under two warps per SM: latency and occupancy
// bound, not bytes.  The design keeps the env in registers (loops over
// compile-time robot counts, no shared or local memory by intent), reads
// each input row and writes each output row once, and draws the reset
// noise (kernel RNG) or reads its rows only on done lanes.
//
// Numerics: built without --use_fast_math and with --fmad=false, so every
// multiply and add rounds as the plain version's separate torch ops do;
// constants are folded in double and rounded to f32 once, by the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "ssl_body.cuh"

#define SSL_PARAMS(X)                                                                              \
  X(dts) X(a_lin) X(a_ang) X(two_pi) X(pi) X(two_r) X(pair_gain)                                   \
  X(ground_z) X(fric) X(gravity_dts) X(neg_rest_ground) X(bounce_min_v) X(r_ball) X(rbt_height)    \
  X(face_dist) X(contact_lo) X(contact_hi) X(reach_hi) X(half_kick_w) X(kicker_height)             \
  X(pull_accel) X(damping) X(capture_speed) X(r_sum) X(ball_gain) X(drib_gain)                     \
  X(max_v) X(max_w_cmd) X(max_w_norm) X(max_pos) X(nbnd) X(kick_speed)                             \
  X(half_len) X(half_wid) X(gk_x) X(half_pen_wid) X(half_goal_wid)                                 \
  X(ball_dist_scale) X(ball_grad_scale) X(energy_scale) X(wheel_r)                                 \
  X(j00) X(j01) X(j02) X(j10) X(j11) X(j12) X(j20) X(j21) X(j22) X(j30) X(j31) X(j32) X(max_steps) \
  X(sp_x_lo) X(sp_x_span) X(sp_y_lo) X(sp_y_span) X(yl_x_span) X(yl_y_span) X(min_d2)             \
  X(en_x_lo) X(en_x_span) X(en_y_lo) X(en_y_span) X(max_kick_x)

struct SslParams {
#define SSL_FIELD(n) float n;
  SSL_PARAMS(SSL_FIELD)
#undef SSL_FIELD
};

namespace {

constexpr int kThreads = 64;
constexpr int K = 8;  // spawn candidates per entity (envs/spawn.N_CANDIDATES)

#define LD(ptr, row) ((ptr)[(size_t)(row) * (size_t)B + b])

// One env's state rows: ball, robots, steps, then NSH task rows (SD/CP:
// shaping accumulators; DR: the checkpoint count; PE: the stopped counter
// and two shaping rows)
template <int N, int NSH>
struct SslEnv {
  SslBall bl;
  float x[N], y[N], th[N], vx[N], vy[N], w[N];
  float steps, extra[NSH];
};

template <int N, int NSH>
__device__ __forceinline__ void load_env(SslEnv<N, NSH>& e, const float* __restrict__ st, int b, int B) {
  e.bl = SslBall{LD(st, 0), LD(st, 1), LD(st, 2), LD(st, 3), LD(st, 4), LD(st, 5)};
#pragma unroll
  for (int r = 0; r < N; ++r) {
    e.x[r] = LD(st, 6 + r);
    e.y[r] = LD(st, 6 + N + r);
    e.th[r] = LD(st, 6 + 2 * N + r);
    e.vx[r] = LD(st, 6 + 3 * N + r);
    e.vy[r] = LD(st, 6 + 4 * N + r);
    e.w[r] = LD(st, 6 + 5 * N + r);
  }
  e.steps = LD(st, 6 + 6 * N);
#pragma unroll
  for (int k = 0; k < NSH; ++k) e.extra[k] = LD(st, 7 + 6 * N + k);
}

template <int N, int NSH>
__device__ __forceinline__ void store_env(const SslEnv<N, NSH>& e, float* __restrict__ st, int b, int B) {
  const float ball[6] = {e.bl.x, e.bl.y, e.bl.z, e.bl.vx, e.bl.vy, e.bl.vz};
#pragma unroll
  for (int k = 0; k < 6; ++k) LD(st, k) = ball[k];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    LD(st, 6 + r) = e.x[r];
    LD(st, 6 + N + r) = e.y[r];
    LD(st, 6 + 2 * N + r) = e.th[r];
    LD(st, 6 + 3 * N + r) = e.vx[r];
    LD(st, 6 + 4 * N + r) = e.vy[r];
    LD(st, 6 + 5 * N + r) = e.w[r];
  }
  LD(st, 6 + 6 * N) = e.steps;
#pragma unroll
  for (int k = 0; k < NSH; ++k) LD(st, 7 + 6 * N + k) = e.extra[k];
}

// The shared task step (ssl_common + the SD/CP transition up to the
// reset): action conversion, world step, termination chain, shaping.
// Steps `e` in place (its first 8 accumulators and `steps` included) and
// leaves the final heading trig in (c, s).
struct SslStep {
  bool chain_done, goal, ir0;
  float reward;
};

// convert_actions: robot 0's action rows 0-2, global -> local, the speed
// scaled only above max_v
__device__ __forceinline__ void convert_action(const SslParams& p, const float* __restrict__ act, float c0,
                                               float s0, float& lvx, float& lvy, float& a_vt, int b, int B) {
  const float a_vx = LD(act, 0) * p.max_v;
  const float a_vy = LD(act, 1) * p.max_v;
  a_vt = LD(act, 2) * p.max_w_cmd;
  lvx = a_vx * c0 + a_vy * s0;
  lvy = -a_vx * s0 + a_vy * c0;
  const float v_norm = sqrtf(lvx * lvx + lvy * lvy);
  const float sc = v_norm < p.max_v ? 1.0f : p.max_v / fmaxf(v_norm, 1e-8f);
  lvx = lvx * sc;
  lvy = lvy * sc;
}

template <int N>
__device__ __forceinline__ void heading_trig(const float (&th)[N], float (&c)[N], float (&s)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    s[r] = sinf(th[r]);
    c[r] = cosf(th[r]);
  }
}

template <int N, int NSH>
__device__ __forceinline__ SslStep task_step(const SslParams& p, SslEnv<N, NSH>& e, float (&c)[N], float (&s)[N],
                                             const float* __restrict__ act, int b, int B) {
  heading_trig(e.th, c, s);
  float lvx, lvy, a_vt;
  convert_action(p, act, c[0], s[0], lvx, lvy, a_vt, b, B);
  const float kick0 = LD(act, 3) > 0.0f ? p.kick_speed : 0.0f;
  const bool drib0 = LD(act, 4) > 0.0f;

  const float x0 = e.x[0], y0 = e.y[0], bx0 = e.bl.x, by0 = e.bl.y;
  SslStep out;
  bool ir[N];
  ssl_world_step<N, 0u>(p, e.x, e.y, e.th, e.vx, e.vy, e.w, c, s, e.bl, lvx, lvy, a_vt, kick0, 0.0f, drib0, ir);
  out.ir0 = ir[0];

  // termination priority chain (static_defenders.py:179-197)
  const float rx = e.x[0], ry = e.y[0], bx = e.bl.x, by = e.bl.y;
  const bool c_rbt_out = rx < -0.2f || fabsf(ry) > p.half_wid;
  const bool c_gk = !c_rbt_out && rx > p.gk_x && fabsf(ry) < p.half_pen_wid;
  const bool c_ball_out = !c_rbt_out && !c_gk && (bx < 0.0f || fabsf(by) > p.half_wid);
  const bool c_ball_right = !c_rbt_out && !c_gk && !c_ball_out && bx > p.half_len;
  out.goal = c_ball_right && fabsf(by) < p.half_goal_wid;
  out.chain_done = c_rbt_out || c_gk || c_ball_out || c_ball_right;
  const bool sb = !out.chain_done;

  // shaping: ball_dist, ball_grad, energy (achieved wheel speeds of robot 0)
  const float dlx = x0 - bx0, dly = y0 - by0, dx = rx - bx, dy = ry - by;
  const float ball_dist = ssl_clampf(sqrtf(dlx * dlx + dly * dly) - sqrtf(dx * dx + dy * dy), -1.0f, 1.0f) /
                          p.ball_dist_scale;
  const float glx = bx0 - p.half_len, gx = bx - p.half_len;
  const float ball_grad =
      ssl_clampf(sqrtf(glx * glx + by0 * by0) - sqrtf(gx * gx + by * by), -1.0f, 1.0f) / p.ball_grad_scale;
  const float u0 = e.vx[0] * c[0] + e.vy[0] * s[0];
  const float s0 = -e.vx[0] * s[0] + e.vy[0] * c[0];
  const float J[4][3] = {{p.j00, p.j01, p.j02}, {p.j10, p.j11, p.j12}, {p.j20, p.j21, p.j22}, {p.j30, p.j31, p.j32}};
  float en = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) en = en + fabsf((J[k][0] * u0 + J[k][1] * s0 + J[k][2] * e.w[0]) / p.wheel_r);
  const float energy = -en / p.energy_scale;
  const float shaped = ball_dist + ball_grad + energy;
  out.reward = out.goal ? 5.0f : (sb ? shaped : 0.0f);

  const bool ball_out_right = c_ball_right && !out.goal;
  const float inc[8] = {
      out.goal ? 1.0f : 0.0f, c_gk ? 1.0f : 0.0f, c_ball_out ? 1.0f : 0.0f, ball_out_right ? 1.0f : 0.0f,
      c_rbt_out ? 1.0f : 0.0f, sb ? ball_dist : 0.0f, sb ? ball_grad : 0.0f, sb ? energy : 0.0f,
  };
#pragma unroll
  for (int k = 0; k < 8; ++k) e.extra[k] = e.extra[k] + inc[k];
  e.steps = e.steps + 1.0f;
  return out;
}

// observe_standard: ball 4, robot 0's 8 (infrared 1 or ir_low), others'
// (x, y), from obs row o
template <int N, int NSH>
__device__ __forceinline__ void write_obs(const SslParams& p, const SslEnv<N, NSH>& e, float sin0, float cos0,
                                          bool ir0, float* __restrict__ obs, int o, int b, int B,
                                          float ir_low = 0.0f) {
  auto npos = [&](float v) { return ssl_clampf(v / p.max_pos, -p.nbnd, p.nbnd); };
  auto nv = [&](float v) { return ssl_clampf(v / p.max_v, -p.nbnd, p.nbnd); };
  LD(obs, o++) = npos(e.bl.x);
  LD(obs, o++) = npos(e.bl.y);
  LD(obs, o++) = nv(e.bl.vx);
  LD(obs, o++) = nv(e.bl.vy);
  LD(obs, o++) = npos(e.x[0]);
  LD(obs, o++) = npos(e.y[0]);
  LD(obs, o++) = sin0;
  LD(obs, o++) = cos0;
  LD(obs, o++) = nv(e.vx[0]);
  LD(obs, o++) = nv(e.vy[0]);
  LD(obs, o++) = ssl_clampf(e.w[0] / p.max_w_norm, -p.nbnd, p.nbnd);
  LD(obs, o++) = ir0 ? 1.0f : ir_low;
#pragma unroll
  for (int r = 1; r < N; ++r) {
    LD(obs, o++) = npos(e.x[r]);
    LD(obs, o++) = npos(e.y[r]);
  }
}

// a reset env: robots and ball at rest, ball on the ground, counters zero
template <int N, int NSH>
__device__ __forceinline__ void rest_env(const SslParams& p, SslEnv<N, NSH>& e, float ball_x, float ball_y) {
  e.bl = SslBall{ball_x, ball_y, p.r_ball, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < N; ++r) e.vx[r] = e.vy[r] = e.w[r] = 0.0f;
  e.x[0] = e.y[0] = e.th[0] = 0.0f;
  e.steps = 0.0f;
#pragma unroll
  for (int k = 0; k < NSH; ++k) e.extra[k] = 0.0f;
}

// the post-step outputs shared by SD and CP: state, obs (post-reset;
// robot 0 resets to heading 0), aux with the pre-reset accumulators
template <int N, int NSH>
__device__ __forceinline__ void write_outputs(const SslParams& p, const SslEnv<N, NSH>& e, float sin0, float cos0,
                                              const SslStep& st, bool term, bool trunc, bool done,
                                              const float (&shaping)[NSH], float* __restrict__ st_out,
                                              float* __restrict__ obs_out, float* __restrict__ aux_out, int b,
                                              int B) {
  store_env(e, st_out, b, B);
  write_obs(p, e, done ? 0.0f : sin0, done ? 1.0f : cos0, st.ir0 && !done, obs_out, 0, b, B);
  LD(aux_out, 0) = st.reward;
  LD(aux_out, 1) = term ? 1.0f : 0.0f;
  LD(aux_out, 2) = trunc ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < NSH; ++k) LD(aux_out, 3 + k) = shaping[k];
}

// ---------------------------------------------------------------- SD
template <bool EMIT_FINAL, bool RNG_KERNEL>
__global__ void __launch_bounds__(kThreads)
    sd_full_kernel(const SslParams p, const float* __restrict__ st, const float* __restrict__ act,
                   const float* __restrict__ ball_in, const float* __restrict__ sp_in,
                   const float* __restrict__ th_in, const long long* __restrict__ key, float* __restrict__ st_out,
                   float* __restrict__ obs_out, float* __restrict__ aux_out, int B) {
  constexpr int N = 7, NY = 6, NSH = 8, kObs = 24;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  SslEnv<N, NSH> e;
  load_env(e, st, b, B);
  float c[N], s[N];
  const SslStep out = task_step(p, e, c, s, act, b, B);
  const bool trunc = e.steps >= p.max_steps;
  const bool done = out.chain_done || trunc;
  float shaping[NSH];
#pragma unroll
  for (int k = 0; k < NSH; ++k) shaping[k] = e.extra[k];
  if constexpr (EMIT_FINAL) write_obs(p, e, s[0], c[0], out.ir0, obs_out, kObs, b, B);

  if (done) {  // reset spawn (envs/ssl_static_defenders.reset_state)
    PhiloxKey pk{};
    if constexpr (RNG_KERNEL) pk = philox_load_key(key);
    float u[2 * K];
    if constexpr (RNG_KERNEL) {
      philox_uniforms<2 * K>(pk, (uint32_t)b, 0, u);  // ball: slots 0-15
    } else {
#pragma unroll
      for (int k = 0; k < 2 * K; ++k) u[k] = LD(ball_in, k);
    }
    // ball: the first candidate outside the GK area, else candidate 0
    float px[2 + NY], py[2 + NY];
    px[0] = p.sp_x_lo + u[0] * p.sp_x_span;
    py[0] = p.sp_y_lo + u[K] * p.sp_y_span;
    bool found = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float cx = p.sp_x_lo + u[k] * p.sp_x_span;
      const float cy = p.sp_y_lo + u[K + k] * p.sp_y_span;
      const bool in_gk = cx > p.gk_x && fabsf(cy) < p.half_pen_wid;
      if (!in_gk && !found) {
        px[0] = cx;
        py[0] = cy;
        found = true;
      }
    }
    px[1] = py[1] = 0.0f;  // the blue, preplaced at the origin
    // defenders: the first candidate 0.2 m from everything placed before
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      if constexpr (RNG_KERNEL) {
        philox_uniforms<2 * K>(pk, (uint32_t)b, (uint32_t)(4 + 4 * i), u);  // slots 16+16i
      } else {
#pragma unroll
        for (int k = 0; k < 2 * K; ++k) u[k] = LD(sp_in, i * 2 * K + k);
      }
      float sx = p.sp_x_lo + u[0] * p.yl_x_span;
      float sy = p.sp_y_lo + u[K] * p.yl_y_span;
      found = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float cx = p.sp_x_lo + u[k] * p.yl_x_span;
        const float cy = p.sp_y_lo + u[K + k] * p.yl_y_span;
        bool ok = true;
#pragma unroll
        for (int q = 0; q < 2 + i; ++q) {
          const float ddx = cx - px[q];
          const float ddy = cy - py[q];
          ok = ok && (ddx * ddx + ddy * ddy) >= p.min_d2;
        }
        if (ok && !found) {
          sx = cx;
          sy = cy;
          found = true;
        }
      }
      px[2 + i] = sx;
      py[2 + i] = sy;
    }
    float th_u[NY];
    if constexpr (RNG_KERNEL) {
      philox_uniforms<NY>(pk, (uint32_t)b, 28, th_u);  // slots 112-117
    } else {
#pragma unroll
      for (int i = 0; i < NY; ++i) th_u[i] = LD(th_in, i);
    }
    rest_env(p, e, px[0], py[0]);
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      e.x[1 + i] = px[2 + i];
      e.y[1 + i] = py[2 + i];
      e.th[1 + i] = th_u[i] * p.two_pi;  // in [0, 2 pi); wrapped by the next substep
    }
  }
  write_outputs(p, e, s[0], c[0], out, out.chain_done, trunc, done, shaping, st_out, obs_out, aux_out, b, B);
}

// ---------------------------------------------------------------- CP
template <bool EMIT_FINAL, bool RNG_KERNEL>
__global__ void __launch_bounds__(kThreads)
    cp_full_kernel(const SslParams p, const float* __restrict__ st, const float* __restrict__ act,
                   const float* __restrict__ enemy_in, const long long* __restrict__ key,
                   float* __restrict__ st_out, float* __restrict__ obs_out, float* __restrict__ aux_out, int B) {
  constexpr int N = 2, NSH = 9, kObs = 14;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  SslEnv<N, NSH> e;
  load_env(e, st, b, B);
  float c[N], s[N];
  const SslStep out = task_step(p, e, c, s, act, b, B);
  // the collision check is independent of the chain; shaping still pays
  const bool collision = fabsf(e.vx[1]) > 0.1f || fabsf(e.vy[1]) > 0.1f;
  e.extra[8] = e.extra[8] + (collision ? 1.0f : 0.0f);
  const bool term = collision || out.chain_done;
  const bool trunc = e.steps >= p.max_steps;
  const bool done = term || trunc;
  float shaping[NSH];
#pragma unroll
  for (int k = 0; k < NSH; ++k) shaping[k] = e.extra[k];
  if constexpr (EMIT_FINAL) write_obs(p, e, s[0], c[0], out.ir0, obs_out, kObs, b, B);

  if (done) {  // reset (envs/ssl_contested_possession.reset_state)
    float u[2];
    if constexpr (RNG_KERNEL) {
      philox_uniforms<2>(philox_load_key(key), (uint32_t)b, 0, u);  // enemy: slots 0-1
    } else {
      u[0] = LD(enemy_in, 0);
      u[1] = LD(enemy_in, 1);
    }
    const float ex = p.en_x_lo + u[0] * p.en_x_span;
    const float ey = p.en_y_lo + u[1] * p.en_y_span;
    rest_env(p, e, ex - 0.1f, ey);
    e.x[1] = ex;
    e.y[1] = ey;
    e.th[1] = p.pi;  // facing away
  }
  write_outputs(p, e, s[0], c[0], out, term, trunc, done, shaping, st_out, obs_out, aux_out, b, B);
}

// ---------------------------------------------------------------- DR
// The course (envs/ssl_dribbling.NODES, MARGIN): exact in f32.
constexpr float kNode0 = -0.5f, kNode1 = -1.0f, kNode2 = -1.5f, kNode3 = -2.0f, kMargin = 1.0f;

// DR draws no noise (its reset is deterministic), so one kernel serves both
// RNG modes; the wrapper still advances the key in kernel-RNG mode.
template <bool EMIT_FINAL>
__global__ void __launch_bounds__(kThreads)
    dr_full_kernel(const SslParams p, const float* __restrict__ st, const float* __restrict__ act,
                   float* __restrict__ st_out, float* __restrict__ obs_out, float* __restrict__ aux_out, int B) {
  constexpr int N = 5, NX = 1, kObs = 21;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  SslEnv<N, NX> e;
  load_env(e, st, b, B);
  float c[N], s[N];
  heading_trig(e.th, c, s);
  float lvx, lvy, a_vt;
  convert_action(p, act, c[0], s[0], lvx, lvy, a_vt, b, B);
  const float by0 = e.bl.y;
  bool ir[N];
  ssl_world_step<N, 0u>(p, e.x, e.y, e.th, e.vx, e.vy, e.w, c, s, e.bl, lvx, lvy, a_vt, 0.0f, 0.0f,
                        LD(act, 3) > 0.0f, ir);

  // collision: any yellow moving; the course box
  bool collision = false;
#pragma unroll
  for (int r = 1; r < N; ++r) collision = collision || fabsf(e.vx[r]) > 0.05f || fabsf(e.vy[r]) > 0.05f;
  const float rx = e.x[0], ry = e.y[0], bx = e.bl.x, by = e.bl.y;
  const bool rbt_out = rx < kNode3 - kMargin || rx > kMargin || fabsf(ry) > kMargin;

  // gate automaton on the f32 checkpoint count (exact small integers)
  const bool down = by0 >= 0.0f && by < 0.0f;
  const bool up = by0 < 0.0f && by >= 0.0f;
  const bool in01 = bx < kNode0 && bx > kNode1;
  const bool in12 = bx < kNode1 && bx > kNode2;
  const bool in23 = bx < kNode2 && bx > kNode3;
  const bool in3m = bx > kNode3 - kMargin && bx < kNode3;
  const float count = e.extra[0];
  const bool is_even = fmodf(count, 2.0f) == 0.0f;
  const bool even_ge2 = count >= 2.0f && is_even;
  const bool odd_ge2 = count >= 2.0f && !is_even;
  const bool cross_even = even_ge2 && in23 && down;
  const bool crossed = !rbt_out && ((count == 0.0f && in01 && down) || (count == 1.0f && in12 && up) ||
                                    cross_even || (odd_ge2 && in3m && up));
  const bool reversed_gate = !rbt_out && even_ge2 && in23 && up;
  const float new_count = count + (crossed ? 1.0f : 0.0f);
  const bool completed = !rbt_out && cross_even && new_count == 7.0f;
  const float reward = crossed ? 1.0f : 0.0f;
  const bool term = collision || rbt_out || reversed_gate || completed;
  e.steps = e.steps + 1.0f;
  e.extra[0] = new_count;
  const bool trunc = e.steps >= p.max_steps;
  const bool done = term || trunc;

  // obs head: checkpoint progress; infrared reported in {-1, 1}
  if constexpr (EMIT_FINAL) {
    LD(obs_out, kObs) = (new_count / 6.0f) * 2.0f - 1.0f;
    write_obs(p, e, s[0], c[0], ir[0], obs_out, kObs + 1, b, B, -1.0f);
  }
  if (done) {  // the course (envs/ssl_dribbling.reset_state), heading pi
    rest_env(p, e, -0.1f, 0.0f);
    const float node_x[N] = {0.0f, kNode0, kNode1, kNode2, kNode3};
#pragma unroll
    for (int r = 0; r < N; ++r) {
      e.x[r] = node_x[r];
      e.y[r] = 0.0f;
      e.th[r] = p.pi;
    }
  }
  store_env(e, st_out, b, B);
  LD(obs_out, 0) = (e.extra[0] / 6.0f) * 2.0f - 1.0f;
  // a reset robot 0 faces pi: its obs trig is the f32 sin/cos of pi
  // (sin ~ -8.74e-8, not 0), as the plain version computes it
  write_obs(p, e, done ? sinf(p.pi) : s[0], done ? cosf(p.pi) : c[0], ir[0] && !done, obs_out, 1, b, B, -1.0f);
  LD(aux_out, 0) = reward;
  LD(aux_out, 1) = term ? 1.0f : 0.0f;
  LD(aux_out, 2) = trunc ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------- PE
constexpr int kPeCand = 16;  // envs/ssl_pass_endurance.N_CAND

// per-robot obs block of PE: x, y, sin, cos, w, infrared in {0, 1}
__device__ __forceinline__ void pe_robot_obs(const SslParams& p, float x, float y, float sn, float cs, float w,
                                             bool ir, float* __restrict__ obs, int o, int b, int B) {
  LD(obs, o + 0) = ssl_clampf(x / p.max_pos, -p.nbnd, p.nbnd);
  LD(obs, o + 1) = ssl_clampf(y / p.max_pos, -p.nbnd, p.nbnd);
  LD(obs, o + 2) = sn;
  LD(obs, o + 3) = cs;
  LD(obs, o + 4) = ssl_clampf(w / p.max_w_norm, -p.nbnd, p.nbnd);
  LD(obs, o + 5) = ir ? 1.0f : 0.0f;
}

__device__ __forceinline__ void pe_ball_obs(const SslParams& p, const SslBall& bl, float* __restrict__ obs, int o,
                                            int b, int B) {
  LD(obs, o + 0) = ssl_clampf(bl.x / p.max_pos, -p.nbnd, p.nbnd);
  LD(obs, o + 1) = ssl_clampf(bl.y / p.max_pos, -p.nbnd, p.nbnd);
  LD(obs, o + 2) = ssl_clampf(bl.vx / p.max_v, -p.nbnd, p.nbnd);
  LD(obs, o + 3) = ssl_clampf(bl.vy / p.max_v, -p.nbnd, p.nbnd);
}

template <bool EMIT_FINAL, bool RNG_KERNEL>
__global__ void __launch_bounds__(kThreads)
    pe_full_kernel(const SslParams p, const float* __restrict__ st, const float* __restrict__ act,
                   const float* __restrict__ ball_in, const float* __restrict__ recv_in,
                   const long long* __restrict__ key, float* __restrict__ st_out, float* __restrict__ obs_out,
                   float* __restrict__ aux_out, int B) {
  constexpr int N = 2, NX = 3, kObs = 16;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  SslEnv<N, NX> e;
  load_env(e, st, b, B);
  float c[N], s[N];
  heading_trig(e.th, c, s);
  // the shooter turns and kicks (|a1| > 0.5 deadzone, signed: a negative
  // kick never fires); the receiver is frozen with its dribbler always on
  const float a1 = LD(act, 1);
  const float kick = fabsf(a1) > 0.5f ? a1 : 0.0f;
  const float bx0 = e.bl.x, by0 = e.bl.y;
  bool ir[N];
  ssl_world_step<N, 0x2u>(p, e.x, e.y, e.th, e.vx, e.vy, e.w, c, s, e.bl, 0.0f, 0.0f, LD(act, 0) * p.max_w_cmd,
                          kick * p.max_kick_x, 0.0f, LD(act, 2) > 0.0f, ir);

  const float sx = e.x[0], sy = e.y[0], rx = e.x[1], ry = e.y[1], bx = e.bl.x, by = e.bl.y;
  const bool received = ir[1];
  const float ldx = bx0 - rx, ldy = by0 - ry, dx = bx - rx, dy = by - ry;
  const float last_d = sqrtf(ldx * ldx + ldy * ldy);
  const float d = sqrtf(dx * dx + dy * dy);
  const float ball_grad = ssl_clampf(last_d - d, -1.0f, 1.0f) / p.ball_grad_scale;

  // wrong ball: the integer-centimetre bounding box (the int cast truncates
  // toward zero like the reference's int()) and the stopped counter
  auto cm = [](float v) { return (int)(v * 100.0f); };
  const int cbx = cm(bx), cby = cm(by), csx = cm(sx), csy = cm(sy), crx = cm(rx), cry = cm(ry);
  const bool inside = min(crx, csx) <= cbx && cbx <= max(crx, csx) && min(cry, csy) <= cby && cby <= max(cry, csy);
  const float stopped_new = fabsf(last_d - d) < 0.01f ? e.extra[0] + 1.0f : 0.0f;
  const bool wrong = stopped_new > 20.0f || !inside;
  const float reward = (received ? 1.0f : ball_grad) + (wrong ? -1.0f : 0.0f);
  const bool term = received || wrong;

  // reversed_dist written on terminated steps only; ball_grad summed
  const float srx = rx - sx, sry = ry - sy;
  const float dist_robs = sqrtf(srx * srx + sry * sry);
  const float reversed_dist = (dist_robs - d) / fmaxf(dist_robs, 1e-8f);
  const float shaping[2] = {term ? reversed_dist : e.extra[1], e.extra[2] + (received ? 0.0f : ball_grad)};
  e.extra[0] = stopped_new;
  e.extra[1] = shaping[0];
  e.extra[2] = shaping[1];
  e.steps = e.steps + 1.0f;
  const bool trunc = e.steps >= p.max_steps;
  const bool done = term || trunc;

  if constexpr (EMIT_FINAL) {
    pe_ball_obs(p, e.bl, obs_out, kObs, b, B);
#pragma unroll
    for (int r = 0; r < N; ++r) pe_robot_obs(p, e.x[r], e.y[r], s[r], c[r], e.w[r], ir[r], obs_out, kObs + 4 + 6 * r, b, B);
  }
  float obs_s[N] = {s[0], s[1]}, obs_c[N] = {c[0], c[1]};
  if (done) {  // reset (envs/ssl_pass_endurance.reset_state)
    float u[2 + kPeCand];
    if constexpr (RNG_KERNEL) {
      philox_uniforms<2 + kPeCand>(philox_load_key(key), (uint32_t)b, 0, u);  // ball 0-1, recv_x 2-17
    } else {
      u[0] = LD(ball_in, 0);
      u[1] = LD(ball_in, 1);
#pragma unroll
      for (int k = 0; k < kPeCand; ++k) u[2 + k] = LD(recv_in, k);
    }
    const float rbx = -1.5f + u[0] * 3.0f;
    const float rby = -1.5f + u[1] * 3.0f;
    const float factor = rby >= 0.0f ? 1.0f : -1.0f;
    const float shy = rby + 0.115f * factor;
    const float sht = factor > 0.0f ? -0.5f * p.pi : 0.5f * p.pi;  // facing the ball
    // receiver x: the first candidate at least 1 m from the ball's, else
    // candidate 0
    float recv_x = -1.5f + u[2] * 3.0f;
    bool found = false;
#pragma unroll
    for (int k = 0; k < kPeCand; ++k) {
      const float cand = -1.5f + u[2 + k] * 3.0f;
      if (fabsf(cand - rbx) >= 1.0f && !found) {
        recv_x = cand;
        found = true;
      }
    }
    const float recv_y = -rby;
    const float rdx = recv_x - rbx, rdy = recv_y - shy;
    rest_env(p, e, rbx, rby);
    e.x[0] = rbx;
    e.y[0] = shy;
    e.th[0] = sht;
    e.x[1] = recv_x;
    e.y[1] = recv_y;
    e.th[1] = atan2f(rdy, rdx) + p.pi;  // aimed back at the shooter
    obs_s[0] = sinf(sht);
    obs_c[0] = cosf(sht);
    // the receiver's trig is the negated unit vector shooter -> receiver
    const float inv = rsqrtf(fmaxf(rdx * rdx + rdy * rdy, 1e-16f));
    obs_s[1] = -rdy * inv;
    obs_c[1] = -rdx * inv;
  }
  store_env(e, st_out, b, B);
  pe_ball_obs(p, e.bl, obs_out, 0, b, B);
#pragma unroll
  for (int r = 0; r < N; ++r) pe_robot_obs(p, e.x[r], e.y[r], obs_s[r], obs_c[r], e.w[r], ir[r] && !done, obs_out, 4 + 6 * r, b, B);
  LD(aux_out, 0) = reward;
  LD(aux_out, 1) = term ? 1.0f : 0.0f;
  LD(aux_out, 2) = trunc ? 1.0f : 0.0f;
  LD(aux_out, 3) = shaping[0];
  LD(aux_out, 4) = shaping[1];
}

#undef LD

template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int B, cudaStream_t stream, Args... args) {
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  kernel<<<grid, block, 0, stream>>>(args..., B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// field names of SslParams in order, comma-terminated; the Python side
// checks its ctypes mirror against this string before the first launch
const char* ssl_params_fields() {
#define SSL_NAME(n) #n ","
  return SSL_PARAMS(SSL_NAME);
#undef SSL_NAME
}

// One fused SSLStaticDefenders-v0 step (N = 7); noise rows ball_u (16, B),
// spawn_u (96, B), theta_u (6, B), or key (rng_kernel).  Returns a
// cudaError_t.
int ssl_sd_full_step(int emit_final, int rng_kernel, const SslParams* p, const float* st, const float* act,
                     const float* ball_u, const float* spawn_u, const float* theta_u, const long long* key,
                     float* st_out, float* obs_out, float* aux_out, int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define SD_LAUNCH(EF, RK) \
  launch(sd_full_kernel<EF, RK>, B, s, *p, st, act, ball_u, spawn_u, theta_u, key, st_out, obs_out, aux_out)
  if (emit_final && rng_kernel) return (int)SD_LAUNCH(true, true);
  if (emit_final) return (int)SD_LAUNCH(true, false);
  if (rng_kernel) return (int)SD_LAUNCH(false, true);
  return (int)SD_LAUNCH(false, false);
#undef SD_LAUNCH
}

// One fused SSLContestedPossession-v0 step (N = 2); noise rows enemy_u
// (2, B), or key (rng_kernel).  Returns a cudaError_t.
int ssl_cp_full_step(int emit_final, int rng_kernel, const SslParams* p, const float* st, const float* act,
                     const float* enemy_u, const long long* key, float* st_out, float* obs_out, float* aux_out,
                     int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define CP_LAUNCH(EF, RK) launch(cp_full_kernel<EF, RK>, B, s, *p, st, act, enemy_u, key, st_out, obs_out, aux_out)
  if (emit_final && rng_kernel) return (int)CP_LAUNCH(true, true);
  if (emit_final) return (int)CP_LAUNCH(true, false);
  if (rng_kernel) return (int)CP_LAUNCH(false, true);
  return (int)CP_LAUNCH(false, false);
#undef CP_LAUNCH
}

// One fused SSLDribbling-v0 step (N = 5).  It draws no noise: rng_kernel
// selects nothing (the wrapper advances the key).  Returns a cudaError_t.
int ssl_dr_full_step(int emit_final, int rng_kernel, const SslParams* p, const float* st, const float* act,
                     float* st_out, float* obs_out, float* aux_out, int B, void* stream) {
  (void)rng_kernel;
  const cudaStream_t s = (cudaStream_t)stream;
  if (emit_final) return (int)launch(dr_full_kernel<true>, B, s, *p, st, act, st_out, obs_out, aux_out);
  return (int)launch(dr_full_kernel<false>, B, s, *p, st, act, st_out, obs_out, aux_out);
}

// One fused SSLPassEndurance-v0 step (N = 2); noise rows ball_u (2, B) and
// recv_u (16, B), or key (rng_kernel).  Returns a cudaError_t.
int ssl_pe_full_step(int emit_final, int rng_kernel, const SslParams* p, const float* st, const float* act,
                     const float* ball_u, const float* recv_u, const long long* key, float* st_out, float* obs_out,
                     float* aux_out, int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define PE_LAUNCH(EF, RK) \
  launch(pe_full_kernel<EF, RK>, B, s, *p, st, act, ball_u, recv_u, key, st_out, obs_out, aux_out)
  if (emit_final && rng_kernel) return (int)PE_LAUNCH(true, true);
  if (emit_final) return (int)PE_LAUNCH(true, false);
  if (rng_kernel) return (int)PE_LAUNCH(false, true);
  return (int)PE_LAUNCH(false, false);
#undef PE_LAUNCH
}

}  // extern "C"
