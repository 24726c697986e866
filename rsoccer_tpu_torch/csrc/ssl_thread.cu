// Fused SSLStaticDefenders-v0 (K4, N = 7) and SSLDribbling-v0 (K6, N = 5)
// steps on one thread per env: sd_thread_kernel and dr_thread_kernel, the
// second design of ssl_full.cu's SD and DR steps (the TPU kernels they
// replace, the per-env work and the numerics are there), which the wrapper
// launches above ops/ssl_full.GROUP_MAX_ENVS (SD 8448, DR 4096 envs).  A source of their own,
// so that nvcc builds them beside ssl_full.cu.
//
// One env per thread, 128 threads per block, each row read or written by
// consecutive threads at consecutive addresses (coalesced without
// staging), every loop over the robots unrolled.  What bounds them (PERF.md,
// section 6): the substeps are a long dependent chain per thread, issued
// from as many warps as the registers leave resident (issue-bound once the
// card is full), the load and store phases of the warps that run at once
// stand beside them, and in the kernels this design replaced a done env's
// reset ran on its lane alone while the other 31 lanes of its warp waited.
// So:
//  - only what the substeps read stays in registers through them (the
//    ball and the robots, the trig, the drive targets).  The rows that
//    only the outcome reads (steps, SD's 8 shaping accumulators, DR's
//    checkpoint count) and the outcome's start values (SD: ball and robot
//    0 x, y; DR: ball y) go to a [value][thread] shared array by 4-byte
//    asynchronous copies (cp_async.cuh) that hold no register and land
//    while the thread steps;
//  - SD's reset runs on the whole warp (sd_spawn): the done envs of a warp
//    in rounds of up to 4, one on each 8-lane group; a round's 30 Philox
//    blocks per env drawn once, spread over the 32 lanes, into shared
//    memory; lane k of a group tests candidate k of each entity and the
//    group votes for the first valid one (first_valid), as the group
//    kernel does.  Philox is counter-based and the candidate order fixed:
//    the same words and the same choice as one lane drawing them all.  The
//    stores of every env that is not done come first, so the reset holds
//    none of the step's registers;
//  - DR's reset (the fixed course) is a select on the done thread; sin and
//    cos of pi only there;
//  - the world step (ssl_body.cuh) wraps a heading with fmodf only outside
//    [0, 2 pi) of t + pi, takes sin and cos of one angle from one sincosf,
//    and 1 / sqrt of its normal arguments from one MUFU.RSQ: each the bits
//    of what it replaces on every f32;
//  - the launch bounds are the sweep's: 128 threads per block, SD held to
//    128 registers (16 warps per SM), DR to 80 (24).  Two envs per thread
//    above one wave, the second's rows prefetched into shared memory while
//    the first steps, measured slower and was not kept (PERF.md).
// The results are the bits of the kernels they replaced, on every input
// (chip_smoke.py --baseline).
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "philox.cuh"
#include "ssl_task.cuh"

namespace {

// the one-thread kernels' block and launch bounds, from the sweep of
// tools/thread_probe (PERF.md, section 6): SD held to 128 registers (16
// warps per SM; left free, its kernel-RNG variant took 209), DR to 80 (24).
// The best bounds move with the batch (SD at 256 threads per block: 4-11%
// faster from 65536 envs on, 18% slower at 10240-16384); one launch
// configuration per kernel keeps one instantiation
constexpr int kThreadBlock = 128;
constexpr int kSdMinBlocks = 4, kDrMinBlocks = 6;

// ---------------------------------------------------------------- SD
// SD's cold values: steps, the 8 shaping accumulators, then the outcome's
// start values ball x, ball y, robot 0 x, robot 0 y
constexpr int kSdRobots = 7, kSdCold = 13;

// state row of SD's cold value i
__device__ __forceinline__ int sd_cold_row(int i) {
  constexpr int N = kSdRobots;
  return i < 9 ? 6 + 6 * N + i : i == 9 ? 0 : i == 10 ? 1 : i == 11 ? 6 : 6 + N;
}

constexpr int kSpawnBlocks = 30;  // Philox blocks of a reset: ball 0-3, defender d 4 + 4d.., theta 28-29
constexpr int kRoundEnvs = 32 / kGroup;  // done envs a warp spawns at once: one on each 8-lane group
constexpr int kSpawnOut = 20;  // a spawn: ball x, y; defender d's x, y (2 + 2d, 3 + 2d); headings 14..19

// one warp's spawn slots in shared memory
template <bool RNG_KERNEL>
struct SdSpawnSlots {
  uint4 words[RNG_KERNEL ? kRoundEnvs * kSpawnBlocks : 1];  // env-major: env j's block q at j * 30 + q
  float out[kRoundEnvs][kSpawnOut];
};

// The reset spawn (envs/ssl_static_defenders.reset_state) of the warp's
// done envs, in rounds of up to kRoundEnvs: the ball, then 6 defenders,
// each the first of 8 candidates valid against everything placed before
// (the ball outside the GK area; a defender 0.2 m from the ball, the blue
// at the origin and the defenders before it), else candidate 0; then each
// done env's lane stores its reset state and obs rows.  Every lane of the
// warp calls it; `done` is false past B.
template <bool RNG_KERNEL>
__device__ __forceinline__ void sd_spawn(const SslParams& p, bool done, int b, int B,
                                         const float* __restrict__ ball_in, const float* __restrict__ sp_in,
                                         const float* __restrict__ th_in, const long long* __restrict__ key,
                                         uint32_t env_base, float* __restrict__ st_out, float* __restrict__ obs_out,
                                         SdSpawnSlots<RNG_KERNEL>& slots) {
  constexpr int N = kSdRobots, NY = N - 1;
  const int lane = threadIdx.x & 31, g = lane / kGroup, k = lane % kGroup;
  const int b_warp = b - lane;  // the warp's first column
  PhiloxKey pk{};
  if constexpr (RNG_KERNEL) pk = philox_load_key(key, env_base);
  unsigned pending = __ballot_sync(kFullMask, done);
  while (pending) {
    // the round: the first kRoundEnvs done lanes (fewer at the end), env j
    // on group j
    int src[kRoundEnvs];
    unsigned round = 0;
    int n = 0;
#pragma unroll
    for (int j = 0; j < kRoundEnvs; ++j) {
      src[j] = pending ? __ffs(pending) - 1 : 0;
      if (pending) {
        round |= 1u << src[j];
        pending &= pending - 1u;
        ++n;
      }
    }
    auto src_of = [&](int j) { return j == 0 ? src[0] : j == 1 ? src[1] : j == 2 ? src[2] : src[3]; };
    static_assert(kRoundEnvs == 4, "src_of selects among 4");
    const bool active = g < n;  // this lane's group spawns an env of the round
    const int col = b_warp + src_of(g);

    // candidate k of entity i (0 the ball, 1 + d defender d): slots 16 i + k
    // (x) and 16 i + 8 + k (y); theta of robot k: slot 111 + k
    float ux[1 + NY], uy[1 + NY], th_u = 0.0f;
    if constexpr (RNG_KERNEL) {
#pragma unroll 1  // one block per lane for a single done env, the common case
      for (int q = lane; q < kSpawnBlocks * n; q += 32) {  // the round's blocks, spread over the warp
        const int j = q / kSpawnBlocks;
        slots.words[q] = philox_block(pk, (uint32_t)(b_warp + src_of(j)), (uint32_t)(q - j * kSpawnBlocks));
      }
      __syncwarp();
      const uint4* w = slots.words + g * kSpawnBlocks;  // an inactive group reads stale words and keeps nothing
#pragma unroll
      for (int i = 0; i < 1 + NY; ++i) {
        ux[i] = philox_uniform(philox_word(w[4 * i + (k >> 2)], k & 3));
        uy[i] = philox_uniform(philox_word(w[4 * i + 2 + (k >> 2)], k & 3));
      }
      if (k >= 1 && k < N) th_u = philox_uniform(philox_word(w[28 + ((k - 1) >> 2)], (k - 1) & 3));
    } else {
#pragma unroll
      for (int i = 0; i < 1 + NY; ++i) {
        const float* __restrict__ rows = i == 0 ? ball_in : sp_in + (size_t)(2 * K * (i - 1)) * B;
        ux[i] = active ? rows[(size_t)k * B + col] : 0.0f;
        uy[i] = active ? rows[(size_t)(K + k) * B + col] : 0.0f;
      }
      if (active && k >= 1 && k < N) th_u = th_in[(size_t)(k - 1) * B + col];
    }

    float* const out = slots.out[g];
    float px, py;
    {  // ball: valid outside the GK area
      const float cx = p.sp_x_lo + ux[0] * p.sp_x_span;
      const float cy = p.sp_y_lo + uy[0] * p.sp_y_span;
      first_valid(!(cx > p.gk_x && fabsf(cy) < p.half_pen_wid), cx, cy, px, py);
    }
    if (k == 0) {
      out[0] = px;
      out[1] = py;
    }
    // defender i: 0.2 m from everything placed before.  Each candidate's
    // test is brought up to date as each point is placed.
    float cx[NY], cy[NY];
    bool ok[NY];
    auto clears = [&](int d, float qx, float qy) {
      const float ddx = cx[d] - qx;
      const float ddy = cy[d] - qy;
      return (ddx * ddx + ddy * ddy) >= p.min_d2;
    };
#pragma unroll
    for (int d = 0; d < NY; ++d) {
      cx[d] = p.sp_x_lo + ux[1 + d] * p.yl_x_span;
      cy[d] = p.sp_y_lo + uy[1 + d] * p.yl_y_span;
      ok[d] = clears(d, px, py) && clears(d, 0.0f, 0.0f);  // the ball, the blue at the origin
    }
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      first_valid(ok[i], cx[i], cy[i], px, py);
      if (k == 0) {
        out[2 + 2 * i] = px;
        out[3 + 2 * i] = py;
      }
#pragma unroll
      for (int d = i + 1; d < NY; ++d) ok[d] = ok[d] && clears(d, px, py);
    }
    if (k >= 1 && k < N) out[2 + 2 * NY + k - 1] = th_u * p.two_pi;  // in [0, 2 pi); wrapped by the next substep
    __syncwarp();

    if ((round >> lane) & 1u) {  // a done env of the round: its spawn from its group's slots
      const float* o = slots.out[__popc(round & ((1u << lane) - 1u))];
      SslBodies<N> r;
      rest_bodies<N>(p, r, o[0], o[1]);
#pragma unroll
      for (int d = 0; d < NY; ++d) {
        r.x[1 + d] = o[2 + 2 * d];
        r.y[1 + d] = o[3 + 2 * d];
        r.th[1 + d] = o[2 + 2 * NY + d];
      }
      store_bodies<N>(r, st_out, b, B);
      write_obs<N>(p, r, 0.0f, 1.0f, false, obs_out, 0, b, B);  // robot 0 resets to heading 0
    }
    __syncwarp();  // the slots are read before the next round writes them
  }
}

template <bool EMIT_FINAL, bool RNG_KERNEL>
__global__ void __launch_bounds__(kThreadBlock, kSdMinBlocks)
    sd_thread_kernel(const SslParams p, const float* __restrict__ st, const float* __restrict__ act,
                     const float* __restrict__ ball_in, const float* __restrict__ sp_in,
                     const float* __restrict__ th_in, const long long* __restrict__ key, uint32_t env_base,
                     float* __restrict__ st_out, float* __restrict__ obs_out, float* __restrict__ aux_out, int B) {
  constexpr int N = kSdRobots, NSH = 8, kObs = 24;
  __shared__ float cold[kSdCold * kThreadBlock];
  __shared__ SdSpawnSlots<RNG_KERNEL> spawn[kThreadBlock / 32];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  bool done = false;  // no thread returns early: the reset needs the whole warp
  if (b < B) {
    // ---- load: the cold values on their way to shared memory, the bodies
    float* const my_cold = cold + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kSdCold; ++i) copy_async4(my_cold + i * kThreadBlock, &LD(st, sd_cold_row(i)));
    SslBodies<N> e;
    load_bodies<N>(e, st, b, B);

    // ---- action and trig: robot 0's action rows 0-2, kick, dribbler
    float c[N], s[N];
    heading_trig(e.th, c, s);
    float lvx, lvy, a_vt;
    convert_action(p, LD(act, 0), LD(act, 1), LD(act, 2), c[0], s[0], lvx, lvy, a_vt);
    const float kick0 = LD(act, 3) > 0.0f ? p.kick_speed : 0.0f;
    const bool drib0 = LD(act, 4) > 0.0f;

    // ---- substeps
    bool ir[N];
    ssl_world_step<N, 0u>(p, e.x, e.y, e.th, e.vx, e.vy, e.w, c, s, e.bl, lvx, lvy, a_vt, kick0, 0.0f, drib0, ir);

    // ---- outcome: the termination chain and shaping, on the cold values
    // waited for only now
    copy_async4_wait();
    float cv[kSdCold];
#pragma unroll
    for (int i = 0; i < kSdCold; ++i) cv[i] = my_cold[i * kThreadBlock];
    float inc[NSH];
    const SslStep out = sd_outcome(p, cv[11], cv[12], cv[9], cv[10], e.x[0], e.y[0], e.vx[0], e.vy[0], e.w[0], c[0],
                                   s[0], e.bl.x, e.bl.y, inc);
    const float reward = out.reward;
    const float steps = cv[0] + 1.0f;
    const bool trunc = steps >= p.max_steps;
    done = out.chain_done || trunc;

    // ---- final obs and outputs: the aux rows (the pre-reset
    // accumulators) and the counters of every env, the state and obs rows
    // of the envs that go on (a done env's come from the reset)
    if constexpr (EMIT_FINAL) write_obs<N>(p, e, s[0], c[0], ir[0], obs_out, kObs, b, B);
    LD(aux_out, 0) = reward;
    LD(aux_out, 1) = out.chain_done ? 1.0f : 0.0f;
    LD(aux_out, 2) = trunc ? 1.0f : 0.0f;
    LD(st_out, 6 + 6 * N) = done ? 0.0f : steps;
#pragma unroll
    for (int q = 0; q < NSH; ++q) {
      const float sh = cv[1 + q] + inc[q];
      LD(st_out, 7 + 6 * N + q) = done ? 0.0f : sh;
      LD(aux_out, 3 + q) = sh;
    }
    if (!done) {
      store_bodies<N>(e, st_out, b, B);
      write_obs<N>(p, e, s[0], c[0], ir[0], obs_out, 0, b, B);
    }
  }

  // ---- reset: the warps that hold a done env spawn it together
  if (__any_sync(kFullMask, done))
    sd_spawn<RNG_KERNEL>(p, done, b, B, ball_in, sp_in, th_in, key, env_base, st_out, obs_out, spawn[threadIdx.x / 32]);
}

// ---------------------------------------------------------------- DR
// DR's cold values: steps, the checkpoint count, the ball's y at the
// step's start
constexpr int kDrRobots = 5, kDrCold = 3;

// state row of DR's cold value i
__device__ __forceinline__ int dr_cold_row(int i) { return i == 0 ? 6 + 6 * kDrRobots : i == 1 ? 7 + 6 * kDrRobots : 1; }

// DR draws no noise (its reset is deterministic), so one kernel serves both
// RNG modes; the wrapper still advances the key in kernel-RNG mode.
template <bool EMIT_FINAL>
__global__ void __launch_bounds__(kThreadBlock, kDrMinBlocks)
    dr_thread_kernel(const SslParams p, const float* __restrict__ st, const float* __restrict__ act,
                     float* __restrict__ st_out, float* __restrict__ obs_out, float* __restrict__ aux_out, int B) {
  constexpr int N = kDrRobots, kObs = 21;
  __shared__ float cold[kDrCold * kThreadBlock];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  // ---- load: the cold values on their way to shared memory, the bodies
  float* const my_cold = cold + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kDrCold; ++i) copy_async4(my_cold + i * kThreadBlock, &LD(st, dr_cold_row(i)));
  SslBodies<N> e;
  load_bodies<N>(e, st, b, B);

  // ---- action and trig: robot 0's action rows 0-2, dribbler
  float c[N], s[N];
  heading_trig(e.th, c, s);
  float lvx, lvy, a_vt;
  convert_action(p, LD(act, 0), LD(act, 1), LD(act, 2), c[0], s[0], lvx, lvy, a_vt);
  const bool drib0 = LD(act, 3) > 0.0f;

  // ---- substeps
  bool ir[N];
  ssl_world_step<N, 0u>(p, e.x, e.y, e.th, e.vx, e.vy, e.w, c, s, e.bl, lvx, lvy, a_vt, 0.0f, 0.0f, drib0, ir);

  // ---- outcome: collision (any yellow moving), the course box, the gates
  bool collision = false;
#pragma unroll
  for (int r = 1; r < N; ++r) collision = collision || fabsf(e.vx[r]) > 0.05f || fabsf(e.vy[r]) > 0.05f;
  copy_async4_wait();
  const float steps = my_cold[0] + 1.0f;
  const DrStep out = dr_outcome(p, my_cold[2 * kThreadBlock], e.x[0], e.y[0], e.bl.x, e.bl.y, my_cold[kThreadBlock],
                                collision);
  const float reward = out.reward;
  const bool trunc = steps >= p.max_steps;
  const bool done = out.term || trunc;

  // ---- final obs and outputs: obs head, checkpoint progress; infrared
  // reported in {-1, 1}; the counters and aux rows
  if constexpr (EMIT_FINAL) {
    LD(obs_out, kObs) = (out.new_count / 6.0f) * 2.0f - 1.0f;
    write_obs<N>(p, e, s[0], c[0], ir[0], obs_out, kObs + 1, b, B, -1.0f);
  }
  const float count = done ? 0.0f : out.new_count;
  LD(st_out, 6 + 6 * N) = done ? 0.0f : steps;
  LD(st_out, 7 + 6 * N) = count;
  LD(obs_out, 0) = (count / 6.0f) * 2.0f - 1.0f;
  LD(aux_out, 0) = reward;
  LD(aux_out, 1) = out.term ? 1.0f : 0.0f;
  LD(aux_out, 2) = trunc ? 1.0f : 0.0f;

  // ---- reset: the course (envs/ssl_dribbling.reset_state), heading pi
  float sin0 = s[0], cos0 = c[0];
  if (done) {
    rest_bodies<N>(p, e, -0.1f, 0.0f);
    const float node_x[N] = {0.0f, kNode0, kNode1, kNode2, kNode3};
#pragma unroll
    for (int r = 0; r < N; ++r) {
      e.x[r] = node_x[r];
      e.y[r] = 0.0f;
      e.th[r] = p.pi;
    }
    // a reset robot 0 faces pi: its obs trig is the f32 sin/cos of pi
    // (sin ~ -8.74e-8, not 0), as the plain version computes it
    sincosf(p.pi, &sin0, &cos0);
  }
  store_bodies<N>(e, st_out, b, B);
  write_obs<N>(p, e, sin0, cos0, ir[0] && !done, obs_out, 1, b, B, -1.0f);
}

#undef LD

template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int B, cudaStream_t stream, Args... args) {
  const dim3 grid((B + kThreadBlock - 1) / kThreadBlock), block(kThreadBlock);
  kernel<<<grid, block, 0, stream>>>(args..., B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One fused SSLStaticDefenders-v0 step on one thread per env: the
// arguments and outputs of ssl_full.cu's ssl_sd_full_step.  Returns a
// cudaError_t.
int ssl_sd_full_step_one_thread(int emit_final, int rng_kernel, const SslParams* p, const float* st,
                                const float* act, const float* ball_u, const float* spawn_u, const float* theta_u,
                                const long long* key, float* st_out, float* obs_out, float* aux_out, int env_base,
                                int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t eb = (uint32_t)env_base;
#define SD_LAUNCH(EF, RK) \
  launch(sd_thread_kernel<EF, RK>, B, s, *p, st, act, ball_u, spawn_u, theta_u, key, eb, st_out, obs_out, aux_out)
  if (emit_final && rng_kernel) return (int)SD_LAUNCH(true, true);
  if (emit_final) return (int)SD_LAUNCH(true, false);
  if (rng_kernel) return (int)SD_LAUNCH(false, true);
  return (int)SD_LAUNCH(false, false);
#undef SD_LAUNCH
}

// One fused SSLDribbling-v0 step on one thread per env: the arguments and
// outputs of ssl_full.cu's ssl_dr_full_step.
int ssl_dr_full_step_one_thread(int emit_final, int rng_kernel, const SslParams* p, const float* st,
                                const float* act, float* st_out, float* obs_out, float* aux_out, int B,
                                void* stream) {
  (void)rng_kernel;
  const cudaStream_t s = (cudaStream_t)stream;
  if (emit_final) return (int)launch(dr_thread_kernel<true>, B, s, *p, st, act, st_out, obs_out, aux_out);
  return (int)launch(dr_thread_kernel<false>, B, s, *p, st, act, st_out, obs_out, aux_out);
}

}  // extern "C"
