// What the fused SSL steps share (ssl_full.cu: the group kernels of SD and
// DR, the one-thread kernels of CP and PE; ssl_thread.cu: the one-thread
// kernels of SD and DR): the parameter struct, the state-row layout, the
// action conversion, the SD/CP termination chain and shaping, the DR gate
// automaton, the observation and the reset helpers, and the group's
// first-valid vote of the spawn.
//
// Layout: every operand is a flat row-major (rows, B) f32 array read as
// p[row * B + b] (LD below; the TPU kernels' (S, B) state layout byte for
// byte).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_group.cuh"
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

// row `row` of the (rows, B) array `ptr`, column b (the including file
// #undefs it after its kernels)
#define LD(ptr, row) ((ptr)[(size_t)(row) * (size_t)B + b])

namespace {

constexpr int K = 8;  // spawn candidates per entity (envs/spawn.N_CANDIDATES)

// One env's bodies: the ball and N robots (state rows 0 to 6 + 6N)
template <int N>
struct SslBodies {
  SslBall bl;
  float x[N], y[N], th[N], vx[N], vy[N], w[N];
};

// and its other state rows: steps, then NSH task rows (SD/CP: shaping
// accumulators; DR: the checkpoint count; PE: the stopped counter and two
// shaping rows)
template <int N, int NSH>
struct SslEnv : SslBodies<N> {
  float steps, extra[NSH];
};

template <int N>
__device__ __forceinline__ void load_bodies(SslBodies<N>& e, const float* __restrict__ st, int b, int B) {
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
}

template <int N, int NSH>
__device__ __forceinline__ void load_env(SslEnv<N, NSH>& e, const float* __restrict__ st, int b, int B) {
  load_bodies<N>(e, st, b, B);
  e.steps = LD(st, 6 + 6 * N);
#pragma unroll
  for (int k = 0; k < NSH; ++k) e.extra[k] = LD(st, 7 + 6 * N + k);
}

template <int N>
__device__ __forceinline__ void store_bodies(const SslBodies<N>& e, float* __restrict__ st, int b, int B) {
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
}

template <int N, int NSH>
__device__ __forceinline__ void store_env(const SslEnv<N, NSH>& e, float* __restrict__ st, int b, int B) {
  store_bodies<N>(e, st, b, B);
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
__device__ __forceinline__ void convert_action(const SslParams& p, float a0, float a1, float a2, float c0,
                                               float s0, float& lvx, float& lvy, float& a_vt) {
  const float a_vx = a0 * p.max_v;
  const float a_vy = a1 * p.max_v;
  a_vt = a2 * p.max_w_cmd;
  lvx = a_vx * c0 + a_vy * s0;
  lvy = -a_vx * s0 + a_vy * c0;
  const float v_norm = sqrtf(lvx * lvx + lvy * lvy);
  const float sc = v_norm < p.max_v ? 1.0f : p.max_v / fmaxf(v_norm, 1e-8f);
  lvx = lvx * sc;
  lvy = lvy * sc;
}

// one sincosf per heading: sinf's and cosf's bits on every f32
template <int N>
__device__ __forceinline__ void heading_trig(const float (&th)[N], float (&c)[N], float (&s)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) sincosf(th[r], &s[r], &c[r]);
}

// The SD/CP termination chain (static_defenders.py:179-197) and shaping
// (ball_dist, ball_grad, energy: achieved wheel speeds of robot 0) from
// robot 0 and the ball at the step's start (x0, y0, bx0, by0) and end.
// inc: the step's increments of the 8 accumulators.
__device__ __forceinline__ SslStep sd_outcome(const SslParams& p, float x0, float y0, float bx0, float by0, float rx,
                                              float ry, float vx, float vy, float w, float c, float s, float bx,
                                              float by, float (&inc)[8]) {
  SslStep out;
  const bool c_rbt_out = rx < -0.2f || fabsf(ry) > p.half_wid;
  const bool c_gk = !c_rbt_out && rx > p.gk_x && fabsf(ry) < p.half_pen_wid;
  const bool c_ball_out = !c_rbt_out && !c_gk && (bx < 0.0f || fabsf(by) > p.half_wid);
  const bool c_ball_right = !c_rbt_out && !c_gk && !c_ball_out && bx > p.half_len;
  out.goal = c_ball_right && fabsf(by) < p.half_goal_wid;
  out.chain_done = c_rbt_out || c_gk || c_ball_out || c_ball_right;
  const bool sb = !out.chain_done;

  const float dlx = x0 - bx0, dly = y0 - by0, dx = rx - bx, dy = ry - by;
  const float ball_dist = ssl_clampf(sqrtf(dlx * dlx + dly * dly) - sqrtf(dx * dx + dy * dy), -1.0f, 1.0f) /
                          p.ball_dist_scale;
  const float glx = bx0 - p.half_len, gx = bx - p.half_len;
  const float ball_grad =
      ssl_clampf(sqrtf(glx * glx + by0 * by0) - sqrtf(gx * gx + by * by), -1.0f, 1.0f) / p.ball_grad_scale;
  const float u0 = vx * c + vy * s;
  const float s0 = -vx * s + vy * c;
  const float J[4][3] = {{p.j00, p.j01, p.j02}, {p.j10, p.j11, p.j12}, {p.j20, p.j21, p.j22}, {p.j30, p.j31, p.j32}};
  float en = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) en = en + fabsf((J[k][0] * u0 + J[k][1] * s0 + J[k][2] * w) / p.wheel_r);
  const float energy = -en / p.energy_scale;
  const float shaped = ball_dist + ball_grad + energy;
  out.reward = out.goal ? 5.0f : (sb ? shaped : 0.0f);

  const bool ball_out_right = c_ball_right && !out.goal;
  inc[0] = out.goal ? 1.0f : 0.0f;
  inc[1] = c_gk ? 1.0f : 0.0f;
  inc[2] = c_ball_out ? 1.0f : 0.0f;
  inc[3] = ball_out_right ? 1.0f : 0.0f;
  inc[4] = c_rbt_out ? 1.0f : 0.0f;
  inc[5] = sb ? ball_dist : 0.0f;
  inc[6] = sb ? ball_grad : 0.0f;
  inc[7] = sb ? energy : 0.0f;
  return out;
}

template <int N, int NSH>
__device__ __forceinline__ SslStep task_step(const SslParams& p, SslEnv<N, NSH>& e, float (&c)[N], float (&s)[N],
                                             const float* __restrict__ act, int b, int B) {
  heading_trig(e.th, c, s);
  float lvx, lvy, a_vt;
  convert_action(p, LD(act, 0), LD(act, 1), LD(act, 2), c[0], s[0], lvx, lvy, a_vt);
  const float kick0 = LD(act, 3) > 0.0f ? p.kick_speed : 0.0f;
  const bool drib0 = LD(act, 4) > 0.0f;

  const float x0 = e.x[0], y0 = e.y[0], bx0 = e.bl.x, by0 = e.bl.y;
  bool ir[N];
  ssl_world_step<N, 0u>(p, e.x, e.y, e.th, e.vx, e.vy, e.w, c, s, e.bl, lvx, lvy, a_vt, kick0, 0.0f, drib0, ir);
  float inc[8];
  SslStep out = sd_outcome(p, x0, y0, bx0, by0, e.x[0], e.y[0], e.vx[0], e.vy[0], e.w[0], c[0], s[0], e.bl.x,
                           e.bl.y, inc);
  out.ir0 = ir[0];
#pragma unroll
  for (int k = 0; k < 8; ++k) e.extra[k] = e.extra[k] + inc[k];
  e.steps = e.steps + 1.0f;
  return out;
}

// the obs normalisation of positions and velocities
__device__ __forceinline__ float obs_pos(const SslParams& p, float v) {
  return ssl_clampf(v / p.max_pos, -p.nbnd, p.nbnd);
}
__device__ __forceinline__ float obs_vel(const SslParams& p, float v) {
  return ssl_clampf(v / p.max_v, -p.nbnd, p.nbnd);
}

// observe_standard: ball 4, robot 0's 8 (infrared 1 or ir_low), others'
// (x, y), from obs row o
template <int N>
__device__ __forceinline__ void write_obs(const SslParams& p, const SslBodies<N>& e, float sin0, float cos0,
                                          bool ir0, float* __restrict__ obs, int o, int b, int B,
                                          float ir_low = 0.0f) {
  auto npos = [&](float v) { return obs_pos(p, v); };
  auto nv = [&](float v) { return obs_vel(p, v); };
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

// reset bodies: robots and ball at rest, ball on the ground, robot 0 at
// the origin facing 0
template <int N>
__device__ __forceinline__ void rest_bodies(const SslParams& p, SslBodies<N>& e, float ball_x, float ball_y) {
  e.bl = SslBall{ball_x, ball_y, p.r_ball, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < N; ++r) e.vx[r] = e.vy[r] = e.w[r] = 0.0f;
  e.x[0] = e.y[0] = e.th[0] = 0.0f;
}

// a reset env: the bodies at rest, counters zero
template <int N, int NSH>
__device__ __forceinline__ void rest_env(const SslParams& p, SslEnv<N, NSH>& e, float ball_x, float ball_y) {
  rest_bodies<N>(p, e, ball_x, ball_y);
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

// The course (envs/ssl_dribbling.NODES, MARGIN): exact in f32.
constexpr float kNode0 = -0.5f, kNode1 = -1.0f, kNode2 = -1.5f, kNode3 = -2.0f, kMargin = 1.0f;

// The gate automaton on the f32 checkpoint count (exact small integers),
// the course box and the collision flag: the step's reward, termination
// and new count.  by0: the ball's y at the step's start.
struct DrStep {
  bool term;
  float reward, new_count;
};

__device__ __forceinline__ DrStep dr_outcome(const SslParams& p, float by0, float rx, float ry, float bx, float by,
                                             float count, bool collision) {
  const bool rbt_out = rx < kNode3 - kMargin || rx > kMargin || fabsf(ry) > kMargin;
  const bool down = by0 >= 0.0f && by < 0.0f;
  const bool up = by0 < 0.0f && by >= 0.0f;
  const bool in01 = bx < kNode0 && bx > kNode1;
  const bool in12 = bx < kNode1 && bx > kNode2;
  const bool in23 = bx < kNode2 && bx > kNode3;
  const bool in3m = bx > kNode3 - kMargin && bx < kNode3;
  const bool is_even = fmodf(count, 2.0f) == 0.0f;
  const bool even_ge2 = count >= 2.0f && is_even;
  const bool odd_ge2 = count >= 2.0f && !is_even;
  const bool cross_even = even_ge2 && in23 && down;
  const bool crossed = !rbt_out && ((count == 0.0f && in01 && down) || (count == 1.0f && in12 && up) ||
                                    cross_even || (odd_ge2 && in3m && up));
  const bool reversed_gate = !rbt_out && even_ge2 && in23 && up;
  DrStep out;
  out.new_count = count + (crossed ? 1.0f : 0.0f);
  const bool completed = !rbt_out && cross_even && out.new_count == 7.0f;
  out.reward = crossed ? 1.0f : 0.0f;
  out.term = collision || rbt_out || reversed_gate || completed;
  return out;
}

// The first valid candidate of the lane's group (candidate k on lane k),
// else candidate 0: its (x, y) on every lane of the group.  Every lane of
// the warp calls it.
__device__ __forceinline__ void first_valid(bool ok, float cx, float cy, float& x, float& y) {
  const unsigned valid = (__ballot_sync(kFullMask, ok) >> (threadIdx.x & 24u)) & 0xffu;
  const int first = valid ? __ffs(valid) - 1 : 0;
  x = __shfl_sync(kFullMask, cx, first, kGroup);
  y = __shfl_sync(kFullMask, cy, first, kGroup);
}

}  // namespace
