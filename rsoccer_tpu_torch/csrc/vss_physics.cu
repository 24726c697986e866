// VSS physics only: one control step (5 substeps) of the differential-drive
// world, one env on a group of lanes (vss_physics_kernel: N = 6 on 8 lanes,
// N = 10 on 16) or on one thread (vss_physics_thread_kernel, N = 1..10).
//
// Replaces the TPU kernel rsoccer_tpu/ops/pallas_vss.py:37
// (make_pallas_vss_physics, pallas_call :194), which BatchedEnv's
// pallas_physics path runs between the task's pre- and post-physics.  Per
// substep, as that kernel and physics/vss.py: wheel targets tracked under
// acceleration clamps with lateral slip decay -> heading wrap (exact
// sinf/cosf) -> integrate -> all-pairs robot contacts, every pair reading
// the pre-pass values and each robot's corrections summed in robot order
// (the dense N x N sums) -> robot wall clamp -> ball friction (divided by
// the speed), vertical axis, integrate -> ball-robot contacts -> ball
// walls with goal pockets.  The substep is vss_world.cuh's, under its
// ExactTrig policy; in the group kernel lane k < N owns robot k and reads
// its own command rows, lane l evaluates robot pairs l, l + G, ... (2 of
// 15 on 8 lanes, 3 of 45 on 16), lane N writes the ball's rows; the
// one-thread kernel runs the same operations on one thread
// (vss_thread_substep), so at N = 6 and N = 10 both give the same bits.
//
// Layout: robots (6, N, B) rows [x, y, theta, v_x, v_y, v_theta], ball
// (6, B) [x, y, z, v_x, v_y, v_z], wheel commands (2, N, B) [left, right],
// all flat row-major f32 read as p[row * B + b].  A block of 256 threads
// steps 256 / G envs (32 on 8 lanes, 16 on 16); each row passes through a
// shared-memory tile in one coalesced access (128 bytes, or two full
// 32-byte sectors), read once or written once.  The tile and the exchange
// slots share one buffer, the slots the larger: 24,576 bytes at N = 6
// (32 envs x 48 float4), 31,744 at N = 10 (16 x 124).
//
// What bounds it: at B = 8192 it moves 3.1 MB at N = 6 (96 rows: robots
// and ball in and out, commands in), 0.94 us of HBM time; at N = 10 its 5
// substeps x (10 robots + 45 pairs + 10 ball contacts), 1.5 us of f32 work
// by the operation count, bound it.  One thread per env ran them, with 2N
// sinf/cosf per substep, as one dependent chain on 256 warps: latency
// bound.  A group of lanes per env gives 2048 warps at N = 6 and 4096 at
// N = 10, each lane running one robot's chain and two or three pairs.  At
// large batches, where the card is full, the lanes issue more instructions
// per env than one thread does, and the wrapper launches the one-thread
// kernel (64 threads per block, the env in registers, every row access
// coalesced) instead (ops/vss_physics.GROUP_MAX_ENVS, measured in
// PERF.md).  Its substeps are issue-bound (N = 6 at 131072 envs runs
// within 1.2x of its static SASS issue floor); the turn's cos and sin come
// from one sincosf
// (ExactTrigPaired, bit for bit), and at 7-10 robots a register-capped
// variant (vss_physics_thread_kernel_capped, 128 registers, 16 warps per SM
// against 12) runs above ops/vss_physics.THREAD_UNCAPPED_MAX_ENVS, where
// the uncapped kernel needs more than one wave of the card.
//
// Numerics: --fmad=false and no fast math (ops/_build.py), and sqrtf with
// true division where physics/vss.py divides, so the kernel rounds as its
// plain version does.
#include <cuda_runtime.h>

#include "vss_world.cuh"

#define VSS_PHYS_PARAMS(X)                                                                            \
  X(dts) X(lat_keep) X(a_lin) X(a_ang) X(max_wheel) X(wheel_r) X(two_half_axle) X(half_len) X(half_wid) \
  X(goal_half) X(hl_goal) X(r_ball) X(two_r) X(r_sum) X(xl) X(yl) X(ground_z) X(fric) X(gravity_dts)   \
  X(neg_rest_ground) X(bounce_min_v) X(rbt_height) X(pair_gain) X(ball_gain) X(neg_rest_wall) X(two_pi) X(pi)

struct VssPhysParams {
#define VSS_PHYS_FIELD(n) float n;
  VSS_PHYS_PARAMS(VSS_PHYS_FIELD)
#undef VSS_PHYS_FIELD
};

namespace {

constexpr int kSubsteps = 5;  // PhysicsConfig.n_substeps (the wrapper checks)
constexpr int kThreadBlock = 64;  // the one-thread kernel's block
constexpr int kCappedMinBlocks = 8;  // the capped one-thread kernel: 8 blocks of 64 per SM, 128 registers

template <int N, int G>
__global__ void __launch_bounds__(kThreads, kVssMinBlocks<G>)
    vss_physics_kernel(const VssPhysParams p, const float* __restrict__ rb_in, const float* __restrict__ ball_in,
                       const float* __restrict__ cmd, float* __restrict__ rb_out, float* __restrict__ ball_out,
                       int B) {
  using LG = LaneGroup<G>;
  using L = VssLayout<N, G>;
  constexpr int E = LG::kEnvsPerBlock;
  static_assert(N + 1 <= G, "lane N writes the ball");
  constexpr int TILE_FLOATS = (6 * N + 6 + 2 * N) * LG::kTileStride;  // robots, ball, commands
  constexpr int XCHG_FLOATS = E * L::kSlots * 4;
  // the row tile (before and after the substeps) and the groups' exchange
  // slots (during them) share one buffer
  __shared__ float4 buf[((TILE_FLOATS > XCHG_FLOATS ? TILE_FLOATS : XCHG_FLOATS) + 3) / 4];
  __shared__ int4 desc[L::kDescs];
  float* tile = reinterpret_cast<float*>(buf);
  const int k = threadIdx.x % G;  // lane in the env's group
  const int e = threadIdx.x / G;  // env in the block
  const int b0 = blockIdx.x * E;
  const int rr = k < N ? k : 0;  // lanes past the robots carry robot 0
#define T(row) tile[(row) * LG::kTileStride + e]

  load_rows<6 * N, E>(tile, 0, rb_in, b0, B);
  load_rows<6, E>(tile, 6 * N, ball_in, b0, B);
  load_rows<2 * N, E>(tile, 7 * N, cmd, b0, B);
  if (threadIdx.x < L::kDescs) desc[threadIdx.x] = pair_desc<N>(threadIdx.x);
  __syncthreads();

  VssRobot r;
  r.x = T(rr);
  r.y = T(N + rr);
  r.th = T(2 * N + rr);
  r.vx = T(3 * N + rr);
  r.vy = T(4 * N + rr);
  r.w = T(5 * N + rr);
  {
    const float wl = clampf(T(7 * N + rr), -p.max_wheel, p.max_wheel);
    const float wr = clampf(T(8 * N + rr), -p.max_wheel, p.max_wheel);
    r.v_tgt = p.wheel_r * (wl + wr) / 2.0f;
    r.w_tgt = p.wheel_r * (wr - wl) / p.two_half_axle;
  }
  r.c = cosf(r.th);
  r.s = sinf(r.th);
  VssBall ball{T(6 * N), T(6 * N + 1), T(6 * N + 2), T(6 * N + 3), T(6 * N + 4), T(6 * N + 5)};
  __syncthreads();  // the buffer now takes the groups' exchange slots

  float4* grp = buf + e * L::kSlots;
#pragma unroll 1  // kept rolled: the unrolled body would be 5x the code
  for (int sub = 0; sub < kSubsteps; ++sub) vss_substep<ExactTrig, N, G>(p, k, grp, desc, r, ball);
  __syncthreads();  // the buffer now takes the output rows

  if (k < N) {
    T(k) = r.x;
    T(N + k) = r.y;
    T(2 * N + k) = r.th;
    T(3 * N + k) = r.vx;
    T(4 * N + k) = r.vy;
    T(5 * N + k) = r.w;
  } else if (k == N) {
    T(6 * N) = ball.x;
    T(6 * N + 1) = ball.y;
    T(6 * N + 2) = ball.z;
    T(6 * N + 3) = ball.vx;
    T(6 * N + 4) = ball.vy;
    T(6 * N + 5) = ball.vz;
  }
#undef T
  __syncthreads();
  store_rows<6 * N, E>(tile, 0, rb_out, b0, B);
  store_rows<6, E>(tile, 6 * N, ball_out, b0, B);
}

template <int N, int G>
cudaError_t launch_group(const VssPhysParams& p, const float* robots, const float* ball, const float* cmd,
                         float* robots_out, float* ball_out, int B, cudaStream_t stream) {
  constexpr int E = LaneGroup<G>::kEnvsPerBlock;
  vss_physics_kernel<N, G><<<(B + E - 1) / E, kThreads, 0, stream>>>(p, robots, ball, cmd, robots_out, ball_out, B);
  return cudaGetLastError();
}

// one env's physics step on this thread: the body of both one-thread kernels
template <int N>
__device__ __forceinline__ void vss_physics_thread_step(const VssPhysParams& p, const float* __restrict__ rb_in,
                                                        const float* __restrict__ ball_in,
                                                        const float* __restrict__ cmd, float* __restrict__ rb_out,
                                                        float* __restrict__ ball_out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
#define LD(ptr, row) ((ptr)[(size_t)(row) * (size_t)B + b])
  VssRobot r[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    r[q].x = LD(rb_in, q);
    r[q].y = LD(rb_in, N + q);
    r[q].th = LD(rb_in, 2 * N + q);
    r[q].vx = LD(rb_in, 3 * N + q);
    r[q].vy = LD(rb_in, 4 * N + q);
    r[q].w = LD(rb_in, 5 * N + q);
    const float wl = clampf(LD(cmd, q), -p.max_wheel, p.max_wheel);
    const float wr = clampf(LD(cmd, N + q), -p.max_wheel, p.max_wheel);
    r[q].v_tgt = p.wheel_r * (wl + wr) / 2.0f;
    r[q].w_tgt = p.wheel_r * (wr - wl) / p.two_half_axle;
    cos_sin(r[q].th, r[q].c, r[q].s);
  }
  VssBall ball{LD(ball_in, 0), LD(ball_in, 1), LD(ball_in, 2), LD(ball_in, 3), LD(ball_in, 4), LD(ball_in, 5)};

#pragma unroll 1  // kept rolled: the unrolled body would be 5x the code
  for (int sub = 0; sub < kSubsteps; ++sub)
    vss_thread_substep<N>(p, ExactTrigPaired{}, r, ball);

#pragma unroll
  for (int q = 0; q < N; ++q) {
    LD(rb_out, q) = r[q].x;
    LD(rb_out, N + q) = r[q].y;
    LD(rb_out, 2 * N + q) = r[q].th;
    LD(rb_out, 3 * N + q) = r[q].vx;
    LD(rb_out, 4 * N + q) = r[q].vy;
    LD(rb_out, 5 * N + q) = r[q].w;
  }
  LD(ball_out, 0) = ball.x;
  LD(ball_out, 1) = ball.y;
  LD(ball_out, 2) = ball.z;
  LD(ball_out, 3) = ball.vx;
  LD(ball_out, 4) = ball.vy;
  LD(ball_out, 5) = ball.vz;
#undef LD
}

template <int N>
__global__ void __launch_bounds__(kThreadBlock)
    vss_physics_thread_kernel(const VssPhysParams p, const float* __restrict__ rb_in,
                              const float* __restrict__ ball_in, const float* __restrict__ cmd,
                              float* __restrict__ rb_out, float* __restrict__ ball_out, int B) {
  vss_physics_thread_step<N>(p, rb_in, ball_in, cmd, rb_out, ball_out, B);
}

// the same step, its registers capped for kCappedMinBlocks blocks per SM
template <int N>
__global__ void __launch_bounds__(kThreadBlock, kCappedMinBlocks)
    vss_physics_thread_kernel_capped(const VssPhysParams p, const float* __restrict__ rb_in,
                                     const float* __restrict__ ball_in, const float* __restrict__ cmd,
                                     float* __restrict__ rb_out, float* __restrict__ ball_out, int B) {
  vss_physics_thread_step<N>(p, rb_in, ball_in, cmd, rb_out, ball_out, B);
}

}  // namespace

extern "C" {

// field names of VssPhysParams in order, comma-terminated; the Python side
// checks its ctypes mirror against this string before the first launch
const char* vss_physics_params_fields() {
#define VSS_PHYS_NAME(n) #n ","
  return VSS_PHYS_PARAMS(VSS_PHYS_NAME);
#undef VSS_PHYS_NAME
}

// One physics step of B VSS worlds on the group kernel: n_robots = 6
// (VSS-v0's 3v3) on 8 lanes per env, n_robots = 10 (5v5) on 16.  Returns a
// cudaError_t (cudaErrorInvalidValue for another n_robots).
int vss_physics_step(const VssPhysParams* p, const float* robots, const float* ball, const float* cmd,
                     float* robots_out, float* ball_out, int n_robots, int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_robots == 6) return (int)launch_group<6, 8>(*p, robots, ball, cmd, robots_out, ball_out, B, s);
  if (n_robots == 10) return (int)launch_group<10, 16>(*p, robots, ball, cmd, robots_out, ball_out, B, s);
  return (int)cudaErrorInvalidValue;
}

// The same step on the one-thread kernel, n_robots = 1..10
// (cudaErrorInvalidValue outside).
int vss_physics_step_one_thread(const VssPhysParams* p, const float* robots, const float* ball, const float* cmd,
                                float* robots_out, float* ball_out, int n_robots, int B, void* stream) {
  const dim3 grid((B + kThreadBlock - 1) / kThreadBlock), block(kThreadBlock);
  const cudaStream_t s = (cudaStream_t)stream;
#define VSS_PHYS_THREAD(N)                                                                                      \
  case N:                                                                                                       \
    vss_physics_thread_kernel<N><<<grid, block, 0, s>>>(*p, robots, ball, cmd, robots_out, ball_out, B);     \
    return (int)cudaGetLastError()
  switch (n_robots) {
    VSS_PHYS_THREAD(1);
    VSS_PHYS_THREAD(2);
    VSS_PHYS_THREAD(3);
    VSS_PHYS_THREAD(4);
    VSS_PHYS_THREAD(5);
    VSS_PHYS_THREAD(6);
    VSS_PHYS_THREAD(7);
    VSS_PHYS_THREAD(8);
    VSS_PHYS_THREAD(9);
    VSS_PHYS_THREAD(10);
  }
#undef VSS_PHYS_THREAD
  return (int)cudaErrorInvalidValue;
}

// The one-thread kernel with its registers capped for kCappedMinBlocks
// blocks per SM, n_robots = 7..10 (cudaErrorInvalidValue outside): the
// same arguments and outputs, bit for bit.
int vss_physics_step_one_thread_capped(const VssPhysParams* p, const float* robots, const float* ball,
                                       const float* cmd, float* robots_out, float* ball_out, int n_robots, int B,
                                       void* stream) {
  const dim3 grid((B + kThreadBlock - 1) / kThreadBlock), block(kThreadBlock);
  const cudaStream_t s = (cudaStream_t)stream;
#define VSS_PHYS_THREAD(N)                                                                                       \
  case N:                                                                                                        \
    vss_physics_thread_kernel_capped<N><<<grid, block, 0, s>>>(*p, robots, ball, cmd, robots_out, ball_out, B); \
    return (int)cudaGetLastError()
  switch (n_robots) {
    VSS_PHYS_THREAD(7);
    VSS_PHYS_THREAD(8);
    VSS_PHYS_THREAD(9);
    VSS_PHYS_THREAD(10);
  }
#undef VSS_PHYS_THREAD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
