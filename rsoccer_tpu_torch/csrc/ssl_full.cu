// Fused SSL env steps: SSLStaticDefenders-v0 (N = 7), SSLContestedPossession-v0
// (N = 2), SSLDribbling-v0 (N = 5) and SSLPassEndurance-v0 (N = 2).
//
// Replaces the TPU kernels rsoccer_tpu/ops/pallas_ssl_full.py:456
// (make_pallas_sd_full_step), :824 (make_pallas_cp_full_step), :1086
// (make_pallas_dr_full_step) and :1327 (make_pallas_pe_full_step), and
// their shared launch _build_call (:289).  Per env: action conversion ->
// the SSL world step -> the task's termination and reward (SD/CP: the
// reference's termination chain and shaping; DR: the gate automaton; PE:
// pass received, wrong ball, stopped counter) -> on done envs only, the
// reset (SD: first-valid ball and six separated defenders; CP: the enemy in
// the penalty strip; DR: the fixed course; PE: ball, shooter and the first
// receiver candidate 1 m away) -> auto-reset select -> observation.
//
// Layout: every operand is a flat row-major (rows, B) f32 array read as
// p[row * B + b] (the TPU kernels' (S, B) state layout byte for byte);
// what the steps share is in ssl_task.cuh.
//
// Two designs.  One thread per env (CP and PE here; SD and DR above the
// wrapper's GROUP_MAX_ENVS in ssl_thread.cu, which has their design
// notes): the env in registers, the world step of ssl_body.cuh, each input
// row read and each output row written once, coalesced.  At B = 8192 that
// is 256 warps on 132 SMs, each thread a long dependent scalar chain:
// latency bound.  A group of 8 lanes per env (SD up to its
// GROUP_MAX_ENVS, the main path's 8192 envs; DR up to 4096): the world step of
// ssl_world.cuh, one robot per lane, rows staged through shared memory with
// every load in flight at once, the reset's Philox blocks drawn once per
// env and shared; 2048 warps at B = 8192.  From ~10240 envs on, where the
// card is full, the group kernels issue more instructions per env than one
// thread does (the ball's work on every lane) and lose (PERF.md, section 6).
//
// Numerics: built without --use_fast_math and with --fmad=false, so every
// multiply and add rounds as the plain version's separate torch ops do;
// constants are folded in double and rounded to f32 once, by the wrapper.
// The two designs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "ssl_task.cuh"
#include "ssl_world.cuh"

namespace {

constexpr int kThreadBlock = 64;  // the one-thread-per-env kernels' block (CP, PE)

// ---------------------------------------------------------------- CP
template <bool EMIT_FINAL, bool RNG_KERNEL>
__global__ void __launch_bounds__(kThreadBlock)
    cp_full_kernel(const SslParams p, const float* __restrict__ st, const float* __restrict__ act,
                   const float* __restrict__ enemy_in, const long long* __restrict__ key, uint32_t env_base,
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
      philox_uniforms<2>(philox_load_key(key, env_base), (uint32_t)b, 0, u);  // enemy: slots 0-1
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

// ------------------------------------------- SD and DR: 8 lanes per env
// The group kernels run the world step of ssl_world.cuh.  A block of 256
// threads steps 32 envs; each row of the block's envs passes through a
// shared-memory tile in one coalesced 128-byte access.  Lane k < N owns robot k:
// its state and obs rows.  Lane 7 writes the ball's rows, the env's
// scalars and the aux rows.  Every lane runs the termination chain (each
// needs `done`).  No thread returns early: lanes past B compute on zeros
// and store nothing.
constexpr int kScalarLane = kGroup - 1;

// write_obs on the group: lane k < N its robot's rows of the obs block at
// tile row o, the scalar lane the ball's
template <int N>
__device__ __forceinline__ void group_obs(const SslParams& p, float* tile, int e, int o, int k, const SslRobot& r,
                                          const SslBall& bl, float sin0, float cos0, bool ir0, float ir_low) {
#define T(row) tile[(row) * kTileStride + e]
  if (k == 0) {
    T(o + 4) = obs_pos(p, r.x);
    T(o + 5) = obs_pos(p, r.y);
    T(o + 6) = sin0;
    T(o + 7) = cos0;
    T(o + 8) = obs_vel(p, r.vx);
    T(o + 9) = obs_vel(p, r.vy);
    T(o + 10) = ssl_clampf(r.w / p.max_w_norm, -p.nbnd, p.nbnd);
    T(o + 11) = ir0 ? 1.0f : ir_low;
  } else if (k < N) {
    T(o + 10 + 2 * k) = obs_pos(p, r.x);
    T(o + 11 + 2 * k) = obs_pos(p, r.y);
  } else if (k == kScalarLane) {
    T(o + 0) = obs_pos(p, bl.x);
    T(o + 1) = obs_pos(p, bl.y);
    T(o + 2) = obs_vel(p, bl.vx);
    T(o + 3) = obs_vel(p, bl.vy);
  }
#undef T
}

// this lane's robot's six state rows (N robots)
template <int N>
__device__ __forceinline__ void group_robot_rows(float* tile, int e, int k, const SslRobot& r) {
#define T(row) tile[(row) * kTileStride + e]
  T(6 + k) = r.x;
  T(6 + N + k) = r.y;
  T(6 + 2 * N + k) = r.th;
  T(6 + 3 * N + k) = r.vx;
  T(6 + 4 * N + k) = r.vy;
  T(6 + 5 * N + k) = r.w;
#undef T
}

template <bool EMIT_FINAL, bool RNG_KERNEL>
__global__ void __launch_bounds__(kThreads, 2)
    sd_full_kernel(const SslParams p, const float* __restrict__ st, const float* __restrict__ act,
                   const float* __restrict__ ball_in, const float* __restrict__ sp_in,
                   const float* __restrict__ th_in, const long long* __restrict__ key, uint32_t env_base,
                   float* __restrict__ st_out, float* __restrict__ obs_out, float* __restrict__ aux_out, int B) {
  constexpr int N = 7, NY = 6, NSH = 8, kObs = 24, kAct = 5;
  constexpr int S = 7 + 6 * N + NSH;  // state rows
  constexpr int OBS_ROWS = kObs * (EMIT_FINAL ? 2 : 1);
  constexpr int NAUX = 3 + NSH;
  using L = SslLayout<N>;
  static_assert(K == kGroup && N < kGroup, "spawn candidate k on lane k; lane 7 is free");
  constexpr int IN_ROWS = S + kAct, OUT_ROWS = S + OBS_ROWS + NAUX;
  constexpr int TILE_FLOATS = (IN_ROWS > OUT_ROWS ? IN_ROWS : OUT_ROWS) * kTileStride;
  // the row tile and the groups' exchange slots apart: after the staging a
  // warp touches only its own envs' columns, so no block barrier is needed
  // between staging in and staging out
  __shared__ float4 buf[(TILE_FLOATS + 3) / 4];
  __shared__ float4 xchg[kEnvsPerBlock * L::kSlots];
  constexpr int kSpawnBlocks = 30;  // Philox blocks of the reset: ball 0-3, defender d 4 + 4d.., theta 28-29
  __shared__ uint4 words[RNG_KERNEL ? kEnvsPerBlock * kSpawnBlocks : 1];
  float* tile = reinterpret_cast<float*>(buf);

  const int k = threadIdx.x % kGroup;  // lane in the env's group
  const int e = threadIdx.x / kGroup;  // env in the block
  const int b0 = blockIdx.x * kEnvsPerBlock;
  const int b = b0 + e;
  const bool live = b < B;
  const int rr = k < N ? k : 0;  // lanes past the robots carry robot 0
  float4* grp = xchg + e * L::kSlots;
#define T(row) tile[(row) * kTileStride + e]

  // ---- stage in
  load_rows_in_flight<S>(tile, 0, st, b0, B);
  load_rows_in_flight<kAct>(tile, S, act, b0, B);
  __syncthreads();

  SslRobot r;
  r.x = T(6 + rr);
  r.y = T(6 + N + rr);
  r.th = T(6 + 2 * N + rr);
  r.vx = T(6 + 3 * N + rr);
  r.vy = T(6 + 4 * N + rr);
  r.w = T(6 + 5 * N + rr);
  SslBall bl{T(0), T(1), T(2), T(3), T(4), T(5)};
  const float x_start = T(6), y_start = T(6 + N), bx_start = bl.x, by_start = bl.y;
  const float steps = T(6 + 6 * N);
  float acc[NSH];
#pragma unroll
  for (int q = 0; q < NSH; ++q) acc[q] = T(7 + 6 * N + q);
  const float a0 = T(S), a1 = T(S + 1), a2 = T(S + 2);
  const float kick0 = T(S + 3) > 0.0f ? p.kick_speed : 0.0f;
  const bool drib0 = T(S + 4) > 0.0f;

  // ---- the world step; robots 1..N-1 keep their starting trig
  r.s = sinf(r.th);
  r.c = cosf(r.th);
  float tu = 0.0f, tv = 0.0f, tw = 0.0f;
  if (k == 0) convert_action(p, a0, a1, a2, r.c, r.s, tu, tv, tw);
  SslRobot0 r0;
  bool ir0 = false;
#pragma unroll 1  // kept rolled: the unrolled body would be 5x the code
  for (int sub = 0; sub < kSslSubsteps; ++sub)
    ir0 = ssl_substep<N>(p, k, grp, r, bl, tu, tv, tw, kick0, drib0, r0);

  // ---- termination chain and shaping, every lane
  float inc[NSH];
  const SslStep out = sd_outcome(p, x_start, y_start, bx_start, by_start, r0.x, r0.y, r0.vx, r0.vy, r0.w, r0.c,
                                 r0.s, bl.x, bl.y, inc);
  const float steps_new = steps + 1.0f;
  const bool trunc = steps_new >= p.max_steps;
  const bool done = out.chain_done || trunc;
  if constexpr (EMIT_FINAL) group_obs<N>(p, tile, e, S + kObs, k, r, bl, r0.s, r0.c, ir0, 0.0f);

  // ---- the reset spawn (envs/ssl_static_defenders.reset_state) on warps
  // that hold a done env: the ball, then 6 defenders, each the first of 8
  // candidates valid against everything placed before; then the auto-reset
  // select.  Every lane of such a warp takes part in the votes; the lanes
  // of envs that do not reset compute on what they hold and keep nothing.
  const bool reset = done && live;
  if (__ballot_sync(kFullMask, reset)) {
    // candidate k of entity i (0 the ball, 1 + d defender d): slots
    // 16 i + k (x) and 16 i + 8 + k (y); theta of robot k: slot 111 + k
    float ux[1 + NY], uy[1 + NY], th_u = 0.0f;
    if constexpr (RNG_KERNEL) {
      // the env's 30 spawn blocks, drawn once: lane k draws blocks k, k + 8, ...
      uint4* w = words + e * kSpawnBlocks;
      if (reset) {  // four independent chains (a fixed trip count unrolls and interleaves them)
        const PhiloxKey pk = philox_load_key(key, env_base);
        uint4 blk[(kSpawnBlocks + kGroup - 1) / kGroup];
#pragma unroll
        for (int j = 0; j < (kSpawnBlocks + kGroup - 1) / kGroup; ++j)
          blk[j] = philox_block(pk, (uint32_t)b, (uint32_t)(k + j * kGroup));
#pragma unroll
        for (int j = 0; j < (kSpawnBlocks + kGroup - 1) / kGroup; ++j)
          if (k + j * kGroup < kSpawnBlocks) w[k + j * kGroup] = blk[j];
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 1 + NY; ++i) {
        ux[i] = philox_uniform(philox_word(w[4 * i + (k >> 2)], k & 3));
        uy[i] = philox_uniform(philox_word(w[4 * i + 2 + (k >> 2)], k & 3));
      }
      if (k >= 1 && k < N) th_u = philox_uniform(philox_word(w[28 + ((k - 1) >> 2)], (k - 1) & 3));
    } else {
#pragma unroll
      for (int i = 0; i < 1 + NY; ++i) {
        const float* __restrict__ rows = i == 0 ? ball_in : sp_in + (size_t)(16 * (i - 1)) * B;
        ux[i] = reset ? rows[(size_t)k * B + b] : 0.0f;
        uy[i] = reset ? rows[(size_t)(K + k) * B + b] : 0.0f;
      }
      if (reset && k >= 1 && k < N) th_u = th_in[(size_t)(k - 1) * B + b];
    }
    float px[2 + NY], py[2 + NY];
    {  // ball: valid outside the GK area
      const float cx = p.sp_x_lo + ux[0] * p.sp_x_span;
      const float cy = p.sp_y_lo + uy[0] * p.sp_y_span;
      first_valid(!(cx > p.gk_x && fabsf(cy) < p.half_pen_wid), cx, cy, px[0], py[0]);
    }
    px[1] = py[1] = 0.0f;  // the blue, preplaced at the origin
    // defender i: 0.2 m from everything placed before.  Each candidate's
    // test is brought up to date as each point is placed, so that only the
    // newest point's distance lies between one vote and the next.
    float cx[NY], cy[NY];
    bool ok[NY];
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      cx[i] = p.sp_x_lo + ux[1 + i] * p.yl_x_span;
      cy[i] = p.sp_y_lo + uy[1 + i] * p.yl_y_span;
      ok[i] = true;
    }
    auto clears = [&](int i, int q) {
      const float ddx = cx[i] - px[q];
      const float ddy = cy[i] - py[q];
      return (ddx * ddx + ddy * ddy) >= p.min_d2;
    };
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      if (i == 0) {
#pragma unroll
        for (int d = 0; d < NY; ++d) ok[d] = clears(d, 0) && clears(d, 1);
      }
      first_valid(ok[i], cx[i], cy[i], px[2 + i], py[2 + i]);
#pragma unroll
      for (int d = i + 1; d < NY; ++d) ok[d] = ok[d] && clears(d, 2 + i);
    }
    if (reset) {
      bl = SslBall{px[0], py[0], p.r_ball, 0.0f, 0.0f, 0.0f};
      r.vx = r.vy = r.w = 0.0f;
      if (k == 0) {
        r.x = r.y = r.th = 0.0f;
      } else if (k < N) {
        r.th = th_u * p.two_pi;  // in [0, 2 pi); wrapped by the next substep
#pragma unroll
        for (int i = 0; i < NY; ++i) {  // robot k's point: a select, not an indexed (local-memory) load
          if (i + 1 == k) {
            r.x = px[2 + i];
            r.y = py[2 + i];
          }
        }
      }
    }
  }

  // ---- outputs into the tile: robot 0 resets to heading 0
  if (k < N) group_robot_rows<N>(tile, e, k, r);
  group_obs<N>(p, tile, e, S, k, r, bl, done ? 0.0f : r0.s, done ? 1.0f : r0.c, ir0 && !done, 0.0f);
  if (k == kScalarLane) {
    T(0) = bl.x;
    T(1) = bl.y;
    T(2) = bl.z;
    T(3) = bl.vx;
    T(4) = bl.vy;
    T(5) = bl.vz;
    T(6 + 6 * N) = done ? 0.0f : steps_new;
    const int a = S + OBS_ROWS;
    T(a + 0) = out.reward;
    T(a + 1) = out.chain_done ? 1.0f : 0.0f;
    T(a + 2) = trunc ? 1.0f : 0.0f;
#pragma unroll
    for (int q = 0; q < NSH; ++q) {
      const float sh = acc[q] + inc[q];
      T(7 + 6 * N + q) = done ? 0.0f : sh;
      T(a + 3 + q) = sh;
    }
  }
#undef T
  __syncthreads();

  // ---- stage out
  store_rows<S>(tile, 0, st_out, b0, B);
  store_rows<OBS_ROWS>(tile, S, obs_out, b0, B);
  store_rows<NAUX>(tile, S + OBS_ROWS, aux_out, b0, B);
}

template <bool EMIT_FINAL>
__global__ void __launch_bounds__(kThreads, 2)
    dr_full_kernel(const SslParams p, const float* __restrict__ st, const float* __restrict__ act,
                   float* __restrict__ st_out, float* __restrict__ obs_out, float* __restrict__ aux_out, int B) {
  constexpr int N = 5, kObs = 21, kAct = 4;
  constexpr int S = 7 + 6 * N + 1;  // state rows: + the checkpoint count
  constexpr int OBS_ROWS = kObs * (EMIT_FINAL ? 2 : 1);
  constexpr int NAUX = 3;
  using L = SslLayout<N>;
  constexpr int IN_ROWS = S + kAct, OUT_ROWS = S + OBS_ROWS + NAUX;
  constexpr int TILE_FLOATS = (IN_ROWS > OUT_ROWS ? IN_ROWS : OUT_ROWS) * kTileStride;
  // the row tile and the groups' exchange slots apart: after the staging a
  // warp touches only its own envs' columns, so no block barrier is needed
  // between staging in and staging out
  __shared__ float4 buf[(TILE_FLOATS + 3) / 4];
  __shared__ float4 xchg[kEnvsPerBlock * L::kSlots];
  float* tile = reinterpret_cast<float*>(buf);

  const int k = threadIdx.x % kGroup;
  const int e = threadIdx.x / kGroup;
  const int b0 = blockIdx.x * kEnvsPerBlock;
  const int rr = k < N ? k : 0;
  float4* grp = xchg + e * L::kSlots;
#define T(row) tile[(row) * kTileStride + e]

  load_rows_in_flight<S>(tile, 0, st, b0, B);
  load_rows_in_flight<kAct>(tile, S, act, b0, B);
  __syncthreads();

  SslRobot r;
  r.x = T(6 + rr);
  r.y = T(6 + N + rr);
  r.th = T(6 + 2 * N + rr);
  r.vx = T(6 + 3 * N + rr);
  r.vy = T(6 + 4 * N + rr);
  r.w = T(6 + 5 * N + rr);
  SslBall bl{T(0), T(1), T(2), T(3), T(4), T(5)};
  const float by_start = bl.y;
  const float steps = T(6 + 6 * N), count = T(7 + 6 * N);
  const float a0 = T(S), a1 = T(S + 1), a2 = T(S + 2);
  const bool drib0 = T(S + 3) > 0.0f;

  r.s = sinf(r.th);
  r.c = cosf(r.th);
  float tu = 0.0f, tv = 0.0f, tw = 0.0f;
  if (k == 0) convert_action(p, a0, a1, a2, r.c, r.s, tu, tv, tw);
  SslRobot0 r0;
  bool ir0 = false;
#pragma unroll 1
  for (int sub = 0; sub < kSslSubsteps; ++sub)
    ir0 = ssl_substep<N>(p, k, grp, r, bl, tu, tv, tw, 0.0f, drib0, r0);

  // ---- collision (any yellow moving: a warp vote), course box, gates
  const bool moving = k >= 1 && k < N && (fabsf(r.vx) > 0.05f || fabsf(r.vy) > 0.05f);
  const bool collision = ((__ballot_sync(kFullMask, moving) >> (threadIdx.x & 24u)) & 0xffu) != 0u;
  const DrStep out = dr_outcome(p, by_start, r0.x, r0.y, bl.x, bl.y, count, collision);
  const float steps_new = steps + 1.0f;
  const bool trunc = steps_new >= p.max_steps;
  const bool done = out.term || trunc;
  // obs head: checkpoint progress; infrared reported in {-1, 1}
  if constexpr (EMIT_FINAL) {
    if (k == kScalarLane) T(S + kObs) = (out.new_count / 6.0f) * 2.0f - 1.0f;
    group_obs<N>(p, tile, e, S + kObs + 1, k, r, bl, r0.s, r0.c, ir0, -1.0f);
  }
  float sin0 = r0.s, cos0 = r0.c;
  if (done) {  // the course (envs/ssl_dribbling.reset_state), heading pi
    bl = SslBall{-0.1f, 0.0f, p.r_ball, 0.0f, 0.0f, 0.0f};
    r.x = k == 0 ? 0.0f : k == 1 ? kNode0 : k == 2 ? kNode1 : k == 3 ? kNode2 : kNode3;
    r.y = 0.0f;
    r.th = p.pi;
    r.vx = r.vy = r.w = 0.0f;
    // a reset robot 0 faces pi: its obs trig is the f32 sin/cos of pi
    // (sin ~ -8.74e-8, not 0), as the plain version computes it
    sin0 = sinf(p.pi);
    cos0 = cosf(p.pi);
  }

  // ---- outputs into the tile
  if (k < N) group_robot_rows<N>(tile, e, k, r);
  group_obs<N>(p, tile, e, S + 1, k, r, bl, sin0, cos0, ir0 && !done, -1.0f);
  if (k == kScalarLane) {
    T(0) = bl.x;
    T(1) = bl.y;
    T(2) = bl.z;
    T(3) = bl.vx;
    T(4) = bl.vy;
    T(5) = bl.vz;
    T(6 + 6 * N) = done ? 0.0f : steps_new;
    T(7 + 6 * N) = done ? 0.0f : out.new_count;
    T(S) = ((done ? 0.0f : out.new_count) / 6.0f) * 2.0f - 1.0f;
    const int a = S + OBS_ROWS;
    T(a + 0) = out.reward;
    T(a + 1) = out.term ? 1.0f : 0.0f;
    T(a + 2) = trunc ? 1.0f : 0.0f;
  }
#undef T
  __syncthreads();

  store_rows<S>(tile, 0, st_out, b0, B);
  store_rows<OBS_ROWS>(tile, S, obs_out, b0, B);
  store_rows<NAUX>(tile, S + OBS_ROWS, aux_out, b0, B);
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
__global__ void __launch_bounds__(kThreadBlock)
    pe_full_kernel(const SslParams p, const float* __restrict__ st, const float* __restrict__ act,
                   const float* __restrict__ ball_in, const float* __restrict__ recv_in,
                   const long long* __restrict__ key, uint32_t env_base, float* __restrict__ st_out,
                   float* __restrict__ obs_out, float* __restrict__ aux_out, int B) {
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
      philox_uniforms<2 + kPeCand>(philox_load_key(key, env_base), (uint32_t)b, 0, u);  // ball 0-1, recv_x 2-17
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
    sincosf(sht, &obs_s[0], &obs_c[0]);
    // the receiver's trig is the negated unit vector shooter -> receiver
    const float inv = rsqrt_normal(fmaxf(rdx * rdx + rdy * rdy, 1e-16f));
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

// one thread per env (CP, PE)
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int B, cudaStream_t stream, Args... args) {
  const dim3 grid((B + kThreadBlock - 1) / kThreadBlock), block(kThreadBlock);
  kernel<<<grid, block, 0, stream>>>(args..., B);
  return cudaGetLastError();
}

// a group of kGroup lanes per env (the SD and DR group kernels)
template <class Kernel, class... Args>
cudaError_t launch_group(Kernel kernel, int B, cudaStream_t stream, Args... args) {
  const dim3 grid((B + kEnvsPerBlock - 1) / kEnvsPerBlock), block(kThreads);
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

// One fused SSLStaticDefenders-v0 step (N = 7) on 8 lanes per env; noise
// rows ball_u (16, B), spawn_u (96, B), theta_u (6, B), or key
// (rng_kernel) with env_base, the global index of column 0.  Returns a
// cudaError_t.
int ssl_sd_full_step(int emit_final, int rng_kernel, const SslParams* p, const float* st, const float* act,
                     const float* ball_u, const float* spawn_u, const float* theta_u, const long long* key,
                     float* st_out, float* obs_out, float* aux_out, int env_base, int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t eb = (uint32_t)env_base;
#define SD_LAUNCH(EF, RK) \
  launch_group(sd_full_kernel<EF, RK>, B, s, *p, st, act, ball_u, spawn_u, theta_u, key, eb, st_out, obs_out, aux_out)
  if (emit_final && rng_kernel) return (int)SD_LAUNCH(true, true);
  if (emit_final) return (int)SD_LAUNCH(true, false);
  if (rng_kernel) return (int)SD_LAUNCH(false, true);
  return (int)SD_LAUNCH(false, false);
#undef SD_LAUNCH
}

// One fused SSLContestedPossession-v0 step (N = 2); noise rows enemy_u
// (2, B), or key (rng_kernel) with env_base.  Returns a cudaError_t.
int ssl_cp_full_step(int emit_final, int rng_kernel, const SslParams* p, const float* st, const float* act,
                     const float* enemy_u, const long long* key, float* st_out, float* obs_out, float* aux_out,
                     int env_base, int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t eb = (uint32_t)env_base;
#define CP_LAUNCH(EF, RK) \
  launch(cp_full_kernel<EF, RK>, B, s, *p, st, act, enemy_u, key, eb, st_out, obs_out, aux_out)
  if (emit_final && rng_kernel) return (int)CP_LAUNCH(true, true);
  if (emit_final) return (int)CP_LAUNCH(true, false);
  if (rng_kernel) return (int)CP_LAUNCH(false, true);
  return (int)CP_LAUNCH(false, false);
#undef CP_LAUNCH
}

// One fused SSLDribbling-v0 step (N = 5) on 8 lanes per env.  It draws no
// noise: rng_kernel selects nothing (the wrapper advances the key).
// Returns a cudaError_t.
int ssl_dr_full_step(int emit_final, int rng_kernel, const SslParams* p, const float* st, const float* act,
                     float* st_out, float* obs_out, float* aux_out, int B, void* stream) {
  (void)rng_kernel;
  const cudaStream_t s = (cudaStream_t)stream;
  if (emit_final) return (int)launch_group(dr_full_kernel<true>, B, s, *p, st, act, st_out, obs_out, aux_out);
  return (int)launch_group(dr_full_kernel<false>, B, s, *p, st, act, st_out, obs_out, aux_out);
}

// One fused SSLPassEndurance-v0 step (N = 2); noise rows ball_u (2, B) and
// recv_u (16, B), or key (rng_kernel) with env_base.  Returns a
// cudaError_t.
int ssl_pe_full_step(int emit_final, int rng_kernel, const SslParams* p, const float* st, const float* act,
                     const float* ball_u, const float* recv_u, const long long* key, float* st_out, float* obs_out,
                     float* aux_out, int env_base, int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t eb = (uint32_t)env_base;
#define PE_LAUNCH(EF, RK) \
  launch(pe_full_kernel<EF, RK>, B, s, *p, st, act, ball_u, recv_u, key, eb, st_out, obs_out, aux_out)
  if (emit_final && rng_kernel) return (int)PE_LAUNCH(true, true);
  if (emit_final) return (int)PE_LAUNCH(true, false);
  if (rng_kernel) return (int)PE_LAUNCH(false, true);
  return (int)PE_LAUNCH(false, false);
#undef PE_LAUNCH
}

}  // extern "C"
