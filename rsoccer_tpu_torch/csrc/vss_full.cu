// Fused VSS-v0 env step: the whole step for one env per thread.
//
// Replaces the TPU kernel rsoccer_tpu/ops/pallas_vss_full.py:142
// (make_pallas_vss_full_step, body `compute` at :243).  Per env it runs:
// OU update -> agent action over robot 0 -> wheel conversion with the
// deadzone -> 5 physics substeps (reduced-range Taylor heading rotation,
// pair-list robot contacts, robot wall clamp, ball friction and vertical
// axis, ball-robot contacts, walls with goal pockets) -> reward cascade ->
// shaping accumulators, truncation -> spawn first-valid placement ->
// auto-reset select -> observation.
//
// Layout: every operand is a flat row-major (rows, B) f32 array read as
// p[row * B + b] — consecutive threads read consecutive addresses, so each
// row load is coalesced.  It is the TPU kernel's (S, B) state layout byte
// for byte (the TPU's (8, B/8) view was a relabelling of the same bytes).
//
// What bounds it: at B = 8192 the step moves ~5.8 MB (state in/out, obs,
// aux, actions), about 2 us of HBM time, while each thread runs a long
// dependent scalar chain (5 substeps x 15 pairs + 6 robots, 7 x 8 spawn
// candidates, 36 Philox blocks in the kernel-RNG variant).  8192 threads
// are 256 warps for 132 SMs — under two warps per SM — so the kernel is
// bound by instruction latency and occupancy, not bytes.  The design
// keeps the whole env in registers (fully unrolled loops over
// compile-time robot counts, no shared or local memory), reads each input
// row and writes each output row once, and in the kernel-RNG variant
// draws its ~142 random words in registers instead of streaming them
// through HBM.  64 threads per block spread the 256 warps over 128 SMs.
//
// Numerics: the reduced-range Taylor rotation and the rsqrt normals of the
// TPU kernel are kept (the 5e-5 kernel-vs-plain tolerance was set against
// them).  Built without --use_fast_math and with --fmad=false, so every
// other multiply and add rounds as the plain version's separate ops do.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_collide.cuh"
#include "philox.cuh"

#define VSS_PARAMS(X)                                                                           \
  X(dt) X(dts) X(lat_keep) X(a_lin) X(a_ang) X(max_wheel) X(wheel_r) X(two_half_axle)          \
  X(ou_theta) X(ou_sig_sqdt) X(max_v) X(deadzone)                                               \
  X(half_len) X(half_wid) X(goal_half) X(hl_goal) X(r_ball) X(two_r) X(r_sum) X(xl) X(yl)       \
  X(ground_z) X(fric) X(gravity_dts) X(neg_rest_ground) X(bounce_min_v) X(rbt_height)           \
  X(pair_gain) X(ball_gain) X(neg_rest_wall)                                                    \
  X(half_l_pot) X(length100) X(max_steps)                                                       \
  X(max_pos) X(max_w_rad) X(nbnd)                                                               \
  X(x_lo) X(x_span) X(y_lo) X(y_span) X(min_d2) X(two_pi) X(pi)

struct VssParams {
#define VSS_FIELD(n) float n;
  VSS_PARAMS(VSS_FIELD)
#undef VSS_FIELD
};

namespace {

constexpr int kThreads = 64;
constexpr int K = 8;  // spawn candidates per entity (envs/spawn.N_CANDIDATES)
constexpr int kSubsteps = 5;  // PhysicsConfig.n_substeps (the wrapper checks)

__device__ __forceinline__ float clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

// jnp.sign / torch.sign: 0 at 0
__device__ __forceinline__ float signf(float v) { return (float)(v > 0.0f) - (float)(v < 0.0f); }

// jnp.mod(t + pi, 2 pi) - pi: fmodf takes the dividend's sign, so a
// negative remainder is moved up by one period (floor-mod)
__device__ __forceinline__ float wrap_angle(float t, const VssParams& p) {
  float r = fmodf(t + p.pi, p.two_pi);
  if (r != 0.0f && r < 0.0f) r += p.two_pi;
  return r - p.pi;
}

__device__ __forceinline__ float to_wheel(float a, const VssParams& p) {
  float v = clampf(a * p.max_v, -p.max_v, p.max_v);
  v = fabsf(v) < p.deadzone ? 0.0f : v;
  return v / p.wheel_r;
}

template <int NB, int NY, bool EMIT_FINAL, bool RNG_KERNEL>
__global__ void __launch_bounds__(kThreads)
    vss_full_kernel(const VssParams p, const float* __restrict__ st, const float* __restrict__ act,
                    const float* __restrict__ ou_in, const float* __restrict__ sp_in,
                    const float* __restrict__ th_in, const long long* __restrict__ key,
                    float* __restrict__ st_out, float* __restrict__ obs_out, float* __restrict__ aux_out,
                    int B) {
  constexpr int N = NB + NY;
  constexpr int NSP = (1 + N) * 2 * K;  // spawn uniforms
  static_assert((2 * K) % 4 == 0, "spawn entities must start on a Philox block");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
#define LD(ptr, row) ((ptr)[(size_t)(row) * Bs + b])

  // ---- noise: OU normals (wheel-major rows) and reset headings
  float ou_n[2 * N], th_u[N];
  PhiloxKey pk{};
  if constexpr (RNG_KERNEL) {
    pk = philox_load_key(key);
    // slots after the spawn block: theta (N), OU u1 (2N), OU u2 (2N)
    float tail[5 * N];
    philox_uniforms<5 * N>(pk, (uint32_t)b, NSP / 4, tail);
#pragma unroll
    for (int r = 0; r < N; ++r) th_u[r] = tail[r];
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int i = 2 * r + w;  // normal index in the (N, 2) OU block
        ou_n[w * N + r] = box_muller(tail[N + i], tail[3 * N + i]);
      }
  } else {
#pragma unroll
    for (int r = 0; r < 2 * N; ++r) ou_n[r] = LD(ou_in, r);
#pragma unroll
    for (int r = 0; r < N; ++r) th_u[r] = LD(th_in, r);
  }

  // ---- state
  float bx = LD(st, 0), by = LD(st, 1), bz = LD(st, 2);
  float bvx = LD(st, 3), bvy = LD(st, 4), bvz = LD(st, 5);
  float x[N], y[N], th[N], vx[N], vy[N], w[N], ou[2 * N], shaping[6];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    x[r] = LD(st, 6 + r);
    y[r] = LD(st, 6 + N + r);
    th[r] = LD(st, 6 + 2 * N + r);
    vx[r] = LD(st, 6 + 3 * N + r);
    vy[r] = LD(st, 6 + 4 * N + r);
    w[r] = LD(st, 6 + 5 * N + r);
  }
  const float steps = LD(st, 6 + 6 * N);
#pragma unroll
  for (int r = 0; r < 2 * N; ++r) ou[r] = LD(st, 7 + 6 * N + r);
  const float ball_pot = LD(st, 7 + 8 * N);
  const float has_pot = LD(st, 8 + 8 * N);
#pragma unroll
  for (int k = 0; k < 6; ++k) shaping[k] = LD(st, 9 + 8 * N + k);

  // ---- OU update (envs/ou.ou_update: mu = 0, sigma = 0.5)
#pragma unroll
  for (int r = 0; r < 2 * N; ++r) ou[r] = ou[r] + p.ou_theta * (0.0f - ou[r]) * p.dt + p.ou_sig_sqdt * ou_n[r];

  // ---- actions -> wheels: the agent's action replaces robot 0's OU rows
  float wl[N], wr[N], v_tgt[N], w_tgt[N];
  wl[0] = to_wheel(LD(act, 0), p);
  wr[0] = to_wheel(LD(act, 1), p);
#pragma unroll
  for (int r = 1; r < N; ++r) {
    wl[r] = to_wheel(ou[r], p);
    wr[r] = to_wheel(ou[N + r], p);
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float l = clampf(wl[r], -p.max_wheel, p.max_wheel);
    const float rr = clampf(wr[r], -p.max_wheel, p.max_wheel);
    v_tgt[r] = p.wheel_r * (l + rr) / 2.0f;
    w_tgt[r] = p.wheel_r * (rr - l) / p.two_half_axle;
  }

  // ---- physics substeps; cos/sin of the heading carried across substeps
  float cos_t[N], sin_t[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    cos_t[r] = cosf(th[r]);
    sin_t[r] = sinf(th[r]);
  }
#pragma unroll 1  // kept rolled: the unrolled body would be 5x the code
  for (int sub = 0; sub < kSubsteps; ++sub) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      float u = vx[r] * cos_t[r] + vy[r] * sin_t[r];
      float s = -vx[r] * sin_t[r] + vy[r] * cos_t[r];
      u = u + clampf(v_tgt[r] - u, -p.a_lin, p.a_lin);
      s = s * p.lat_keep;
      w[r] = w[r] + clampf(w_tgt[r] - w[r], -p.a_ang, p.a_ang);
      const float dth = w[r] * p.dts;
      th[r] = wrap_angle(th[r] + dth, p);
      // rotate (cos, sin) by dth: |dth| <= w_max * dts <= 0.35 (checked by
      // the wrapper), where the degree-7/6 Taylor terms are exact to far
      // below f32 resolution — no transcendental in the substep loop
      const float dd = dth * dth;
      const float sin_d =
          dth * (1.0f + dd * ((float)(-1.0 / 6.0) + dd * ((float)(1.0 / 120.0) - dd / 5040.0f)));
      const float cos_d = 1.0f + dd * (-0.5f + dd * ((float)(1.0 / 24.0) - dd / 720.0f));
      const float cos_n = cos_t[r] * cos_d - sin_t[r] * sin_d;
      sin_t[r] = sin_t[r] * cos_d + cos_t[r] * sin_d;
      cos_t[r] = cos_n;
      vx[r] = u * cos_t[r] - s * sin_t[r];
      vy[r] = u * sin_t[r] + s * cos_t[r];
      x[r] = x[r] + vx[r] * p.dts;
      y[r] = y[r] + vy[r] * p.dts;
    }

    resolve_pair_collisions<N>(x, y, vx, vy, p.two_r, p.pair_gain);

#pragma unroll
    for (int r = 0; r < N; ++r) {
      vx[r] = (fabsf(x[r]) > p.xl && vx[r] * signf(x[r]) > 0.0f) ? 0.0f : vx[r];
      vy[r] = (fabsf(y[r]) > p.yl && vy[r] * signf(y[r]) > 0.0f) ? 0.0f : vy[r];
      x[r] = clampf(x[r], -p.xl, p.xl);
      y[r] = clampf(y[r], -p.yl, p.yl);
    }

    // ball: rolling friction while grounded, vertical axis, then contacts
    const bool on_ground = bz <= p.ground_z;
    const float inv_speed = rsqrtf(bvx * bvx + bvy * bvy + 1e-16f);
    const float scale = fmaxf(0.0f, 1.0f - p.fric * inv_speed);
    if (on_ground) {
      bvx = bvx * scale;
      bvy = bvy * scale;
    }
    bvz = bvz - p.gravity_dts;
    bz = bz + bvz * p.dts;
    const bool hit_floor = bz < p.r_ball;
    if (hit_floor && bvz < 0.0f) bvz = p.neg_rest_ground * bvz;
    if (hit_floor && bvz < p.bounce_min_v) bvz = 0.0f;
    if (hit_floor) bz = p.r_ball;
    bx = bx + bvx * p.dts;
    by = by + bvy * p.dts;

    const bool below_top = (bz - p.r_ball) < p.rbt_height;
    float push_x = 0.0f, push_y = 0.0f, imp_x = 0.0f, imp_y = 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float dx = bx - x[r];
      const float dy = by - y[r];
      const float d2 = fmaxf(dx * dx + dy * dy, 1e-16f);
      const float inv_d = rsqrtf(d2);
      const float overlap = p.r_sum - d2 * inv_d;
      const bool col = overlap > 0.0f && below_top;
      const float nx = dx * inv_d, ny = dy * inv_d;
      push_x += (col ? overlap : 0.0f) * nx;
      push_y += (col ? overlap : 0.0f) * ny;
      const float vn = (bvx - vx[r]) * nx + (bvy - vy[r]) * ny;
      const float j = (col && vn < 0.0f) ? p.ball_gain * vn : 0.0f;
      imp_x += j * nx;
      imp_y += j * ny;
    }
    bx = bx + push_x;
    by = by + push_y;
    bvx = bvx + imp_x;
    bvy = bvy + imp_y;

    // walls, with goal pockets behind the end lines
    const bool in_mouth = fabsf(by) < p.goal_half;
    const float x_wall = (in_mouth ? p.hl_goal : p.half_len) - p.r_ball;
    const float sx = signf(bx);
    const bool hit_x = fabsf(bx) > x_wall;
    if (hit_x) bx = sx * x_wall;
    if (hit_x && bvx * sx > 0.0f) bvx = p.neg_rest_wall * bvx;
    const bool in_pocket = fabsf(bx) > p.half_len;
    const float y_wall = (in_pocket ? p.goal_half : p.half_wid) - p.r_ball;
    const float sy = signf(by);
    const bool hit_y = fabsf(by) > y_wall;
    if (hit_y) by = sy * y_wall;
    if (hit_y && bvy * sy > 0.0f) bvy = p.neg_rest_wall * bvy;
  }

  // ---- reward & termination cascade (envs/vss.post_physics)
  const bool goal_blue = bx > p.half_len;
  const bool goal_yellow = bx < -p.half_len;
  const bool goal = goal_blue || goal_yellow;
  const float dx_d = (p.half_l_pot + bx) * 100.0f;
  const float dx_a = (p.half_l_pot - bx) * 100.0f;
  const float dyc = by * 100.0f;
  const float dist_1 = -sqrtf(dx_a * dx_a + 2.0f * dyc * dyc);
  const float dist_2 = sqrtf(dx_d * dx_d + 2.0f * dyc * dyc);
  const float potential = ((dist_1 + dist_2) / p.length100 - 1.0f) / 2.0f;
  const float grad = has_pot > 0.5f ? clampf((potential - ball_pot) * 3.0f / p.dt, -5.0f, 5.0f) : 0.0f;

  float rbx = bx - x[0], rby = by - y[0];
  const float inv_rb = rsqrtf(fmaxf(rbx * rbx + rby * rby, 1e-16f));
  rbx = rbx * inv_rb;
  rby = rby * inv_rb;
  const float move = clampf((rbx * vx[0] + rby * vy[0]) / 0.4f, -5.0f, 5.0f);
  const float energy = -(fabsf(wl[0]) + fabsf(wr[0]));
  const float shaped = 0.2f * move + 0.8f * grad + 2e-4f * energy;
  const float reward = goal_blue ? 10.0f : (goal_yellow ? -10.0f : shaped);

  float shaping_new[6];
  shaping_new[0] = shaping[0] + (goal ? (goal_blue ? 1.0f : -1.0f) : 0.0f);
  shaping_new[1] = shaping[1] + (goal ? 0.0f : 0.2f * move);
  shaping_new[2] = shaping[2] + (goal ? 0.0f : 0.8f * grad);
  shaping_new[3] = shaping[3] + (goal ? 0.0f : 2e-4f * energy);
  shaping_new[4] = shaping[4] + (goal ? (float)goal_blue : 0.0f);
  shaping_new[5] = shaping[5] + (goal ? (float)goal_yellow : 0.0f);

  const float steps_new = steps + 1.0f;
  const bool trunc = steps_new >= p.max_steps;
  const bool done = goal || trunc;

  auto npos = [&](float v) { return clampf(v / p.max_pos, -p.nbnd, p.nbnd); };
  auto nv = [&](float v) { return clampf(v / p.max_v, -p.nbnd, p.nbnd); };
  auto nw = [&](float v) { return clampf(v / p.max_w_rad, -p.nbnd, p.nbnd); };
  const int obs_size = 4 + 7 * NB + 5 * NY;

  // final (pre-reset) observation; heading trig from the substep carry
  if constexpr (EMIT_FINAL) {
    int o = obs_size;
    LD(obs_out, o++) = npos(bx);
    LD(obs_out, o++) = npos(by);
    LD(obs_out, o++) = nv(bvx);
    LD(obs_out, o++) = nv(bvy);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      LD(obs_out, o++) = npos(x[r]);
      LD(obs_out, o++) = npos(y[r]);
      if (r < NB) {
        LD(obs_out, o++) = sin_t[r];
        LD(obs_out, o++) = cos_t[r];
      }
      LD(obs_out, o++) = nv(vx[r]);
      LD(obs_out, o++) = nv(vy[r]);
      LD(obs_out, o++) = nw(w[r]);
    }
  }

  // ---- spawn placement (envs/spawn.place_separated, first valid)
  float px[1 + N], py[1 + N];
#pragma unroll
  for (int i = 0; i < 1 + N; ++i) {
    float u[2 * K];
    if constexpr (RNG_KERNEL) {
      philox_uniforms<2 * K>(pk, (uint32_t)b, (uint32_t)(i * 2 * K / 4), u);
    } else {
#pragma unroll
      for (int k = 0; k < 2 * K; ++k) u[k] = LD(sp_in, i * 2 * K + k);
    }
    float sel_x = p.x_lo + u[0] * p.x_span;
    float sel_y = p.y_lo + u[K] * p.y_span;
    bool found = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float cx = p.x_lo + u[k] * p.x_span;
      const float cy = p.y_lo + u[K + k] * p.y_span;
      bool ok = true;
#pragma unroll
      for (int q = 0; q < i; ++q) {
        const float ddx = cx - px[q];
        const float ddy = cy - py[q];
        ok = ok && (ddx * ddx + ddy * ddy) >= p.min_d2;
      }
      if (ok && !found) {
        sel_x = cx;
        sel_y = cy;
        found = true;
      }
    }
    px[i] = sel_x;
    py[i] = sel_y;
  }

  // ---- auto-reset select: done lanes take the freshly spawned world
  if (done) {
    bx = px[0];
    by = py[0];
    bz = p.r_ball;
    bvx = bvy = bvz = 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      x[r] = px[1 + r];
      y[r] = py[1 + r];
      th[r] = th_u[r] * p.two_pi;
      vx[r] = vy[r] = w[r] = 0.0f;
    }
  }

  // ---- outputs
  LD(st_out, 0) = bx;
  LD(st_out, 1) = by;
  LD(st_out, 2) = bz;
  LD(st_out, 3) = bvx;
  LD(st_out, 4) = bvy;
  LD(st_out, 5) = bvz;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    LD(st_out, 6 + r) = x[r];
    LD(st_out, 6 + N + r) = y[r];
    LD(st_out, 6 + 2 * N + r) = th[r];
    LD(st_out, 6 + 3 * N + r) = vx[r];
    LD(st_out, 6 + 4 * N + r) = vy[r];
    LD(st_out, 6 + 5 * N + r) = w[r];
  }
  LD(st_out, 6 + 6 * N) = done ? 0.0f : steps_new;
#pragma unroll
  for (int r = 0; r < 2 * N; ++r) LD(st_out, 7 + 6 * N + r) = done ? 0.0f : ou[r];
  LD(st_out, 7 + 8 * N) = done ? 0.0f : potential;
  LD(st_out, 8 + 8 * N) = done ? 0.0f : 1.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) LD(st_out, 9 + 8 * N + k) = done ? 0.0f : shaping_new[k];

  {
    int o = 0;
    LD(obs_out, o++) = npos(bx);
    LD(obs_out, o++) = npos(by);
    LD(obs_out, o++) = nv(bvx);
    LD(obs_out, o++) = nv(bvy);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      LD(obs_out, o++) = npos(x[r]);
      LD(obs_out, o++) = npos(y[r]);
      if (r < NB) {
        LD(obs_out, o++) = sinf(th[r]);
        LD(obs_out, o++) = cosf(th[r]);
      }
      LD(obs_out, o++) = nv(vx[r]);
      LD(obs_out, o++) = nv(vy[r]);
      LD(obs_out, o++) = nw(w[r]);
    }
  }

  LD(aux_out, 0) = reward;
  LD(aux_out, 1) = goal ? 1.0f : 0.0f;
  LD(aux_out, 2) = trunc ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) LD(aux_out, 3 + k) = shaping_new[k];
#undef LD
}

template <int NB, int NY>
cudaError_t launch(int emit_final, int rng_kernel, const VssParams& p, const float* st, const float* act,
                   const float* ou, const float* sp, const float* th, const long long* key, float* st_out,
                   float* obs_out, float* aux_out, int B, cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
#define VSS_LAUNCH(EF, RK) \
  vss_full_kernel<NB, NY, EF, RK><<<grid, block, 0, stream>>>(p, st, act, ou, sp, th, key, st_out, obs_out, aux_out, B)
  if (emit_final && rng_kernel) VSS_LAUNCH(true, true);
  else if (emit_final) VSS_LAUNCH(true, false);
  else if (rng_kernel) VSS_LAUNCH(false, true);
  else VSS_LAUNCH(false, false);
#undef VSS_LAUNCH
  return cudaGetLastError();
}

__global__ void philox_words_kernel(const long long* __restrict__ key, uint32_t* __restrict__ out, int n_blk,
                                    int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const PhiloxKey k = philox_load_key(key);
  for (int blk = 0; blk < n_blk; ++blk) {
    const uint4 w = philox_block(k, (uint32_t)b, (uint32_t)blk);
    out[(size_t)(4 * blk + 0) * B + b] = w.x;
    out[(size_t)(4 * blk + 1) * B + b] = w.y;
    out[(size_t)(4 * blk + 2) * B + b] = w.z;
    out[(size_t)(4 * blk + 3) * B + b] = w.w;
  }
}

}  // namespace

extern "C" {

// field names of VssParams in order, comma-terminated; the Python side
// checks its ctypes mirror against this string before the first launch
const char* vss_params_fields() {
#define VSS_NAME(n) #n ","
  return VSS_PARAMS(VSS_NAME);
#undef VSS_NAME
}

// One fused step.  Team size compiled: 3v3 (VSS-v0).  Returns a
// cudaError_t (cudaErrorInvalidValue for a team size not compiled).
int vss_full_step(int n_blue, int n_yellow, int emit_final, int rng_kernel, const VssParams* p,
                  const float* st, const float* act, const float* ou, const float* sp, const float* th,
                  const long long* key, float* st_out, float* obs_out, float* aux_out, int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_blue == 3 && n_yellow == 3)
    return launch<3, 3>(emit_final, rng_kernel, *p, st, act, ou, sp, th, key, st_out, obs_out, aux_out, B, s);
  return (int)cudaErrorInvalidValue;
}

// Raw Philox words of blocks [0, n_blk) for every env: out is (4 n_blk, B)
// u32 — the debug entry that holds the device stream to the torch one.
int philox_words(const long long* key, uint32_t* out, int n_blk, int B, void* stream) {
  const dim3 grid((B + 127) / 128), block(128);
  philox_words_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(key, out, n_blk, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
