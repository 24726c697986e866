// The one-thread VSS step (vss_thread.cu has the design notes): its body,
// its two kernels (vss_thread_kernel, and vss_thread_kernel_bounded under
// __launch_bounds__(kThreadBlock, MIN_BLOCKS)) and their launch.
// vss_thread.cu launches the uncapped kernel and vss_thread_capped.cu the
// capped one, so the two sets of instantiations build in parallel.
#pragma once
#include "cp_async.cuh"
#include "vss_step.cuh"

namespace {

constexpr int kThreadBlock = 64;  // the one-thread kernel's block
constexpr int kCappedMinBlocks = 8;  // the capped one-thread kernel: 8 blocks of 64 per SM, 128 registers
// the uncapped one-thread kernel's blocks per SM (0: no bound): N = 6 held
// to 128 registers (16 warps per SM) and N = 8 to 168 (12), which the
// compiler exceeds in one RNG variant each when left free (168 and 254)
template <int N>
constexpr int kThreadMinBlocks = N == 6 ? 8 : N == 8 ? 6 : 0;
constexpr int kMaxBlue = 5, kMaxYellow = 5;  // the one-thread kernel's team sizes (from 1v0)

// ---------------------------------------------------------------- one thread per env
constexpr int kColdRows = 9;  // the rows the substeps never read: steps, ball_pot, has_pot, shaping[6]

// state row of cold value i
template <int N>
__device__ __forceinline__ int cold_row(int i) {
  return i == 0 ? 6 + 6 * N : 6 + 8 * N + i;
}

#define VSS_THREAD_PARAMS                                                                                    \
  const float *__restrict__ st, const float *__restrict__ act, const float *__restrict__ ou_in,              \
      const float *__restrict__ sp_in, const float *__restrict__ th_in, const long long *__restrict__ key,   \
      uint32_t env_base, float *__restrict__ st_out, float *__restrict__ obs_out, float *__restrict__ aux_out, \
      int B
#define VSS_THREAD_ARGS st, act, ou_in, sp_in, th_in, key, env_base, st_out, obs_out, aux_out, B

// one env's step on this thread: the body of both one-thread kernels
template <int N, bool RNG_KERNEL>
__device__ __forceinline__ void vss_thread_step(const VssParams& p, int nb, bool emit_final, bool exact_trig,
                                                VSS_THREAD_PARAMS) {
  constexpr int NSP = (1 + N) * 2 * K;  // spawn uniforms: slots [0, NSP); then theta, OU u1, OU u2
  static_assert((2 * K) % 4 == 0, "spawn entities start on a Philox block");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
#define LD(ptr, row) ((ptr)[(size_t)(row) * (size_t)B + b])

  // ---- the cold rows (steps, ball potential, shaping), which only the
  // outcome after the substeps reads: copied into this thread's slots of
  // a [value][thread] shared array by 4-byte asynchronous copies, which
  // hold no register while the thread draws and steps
  __shared__ float cold[kColdRows * kThreadBlock];
  float* const my_cold = cold + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kColdRows; ++i) copy_async4(my_cold + i * kThreadBlock, &LD(st, cold_row<N>(i)));

  // ---- the state the substeps carry, the OU rows and the action
  VssRobot r[N];
  float ou[2 * N];  // wheel-major: N wheel-0 rows, then N wheel-1 rows
#pragma unroll
  for (int q = 0; q < N; ++q) {
    r[q].x = LD(st, 6 + q);
    r[q].y = LD(st, 6 + N + q);
    r[q].th = LD(st, 6 + 2 * N + q);
    r[q].vx = LD(st, 6 + 3 * N + q);
    r[q].vy = LD(st, 6 + 4 * N + q);
    r[q].w = LD(st, 6 + 5 * N + q);
    ou[q] = LD(st, 7 + 6 * N + q);
    ou[N + q] = LD(st, 7 + 7 * N + q);
  }
  VssBall ball{LD(st, 0), LD(st, 1), LD(st, 2), LD(st, 3), LD(st, 4), LD(st, 5)};

  // ---- OU update (envs/ou.ou_update: mu = 0, sigma = 0.5): the normals
  // (in the kernel-RNG variant from the Philox blocks of the OU slots, NSP
  // + [N, 5N)); the new OU rows are stored now (a done env zeroes them
  // after the substeps)
  {
    float tail[4 * N];  // slots NSP + N + [0, 2N): OU u1; + [2N, 4N): OU u2
    if constexpr (RNG_KERNEL) philox_slot_range<NSP + N>(philox_load_key(key, env_base), (uint32_t)b, tail);
#pragma unroll
    for (int q = 0; q < N; ++q) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        float n;
        if constexpr (RNG_KERNEL) n = box_muller(tail[2 * q + w], tail[2 * N + 2 * q + w]);
        else n = LD(ou_in, w * N + q);
        float& o = ou[w * N + q];
        o = o + p.ou_theta * (0.0f - o) * p.dt + p.ou_sig_sqdt * n;
        LD(st_out, 7 + (6 + w) * N + q) = o;
      }
    }
  }

  // ---- actions -> wheels: the agent's action replaces robot 0's OU rows
  const float wl0 = to_wheel(LD(act, 0), p), wr0 = to_wheel(LD(act, 1), p);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float l = clampf(q == 0 ? wl0 : to_wheel(ou[q], p), -p.max_wheel, p.max_wheel);
    const float rw = clampf(q == 0 ? wr0 : to_wheel(ou[N + q], p), -p.max_wheel, p.max_wheel);
    r[q].v_tgt = p.wheel_r * (l + rw) / 2.0f;
    r[q].w_tgt = p.wheel_r * (rw - l) / p.two_half_axle;
  }

  // ---- physics substeps; cos/sin of the heading carried across substeps
#pragma unroll
  for (int q = 0; q < N; ++q) cos_sin(r[q].th, r[q].c, r[q].s);
  const RsqrtPickedTurn pol{{}, exact_trig};
#pragma unroll 1  // kept rolled: the unrolled body would be 5x the code
  for (int sub = 0; sub < kSubsteps; ++sub) vss_thread_substep<N>(p, pol, r, ball);

  // ---- reward & termination cascade (envs/vss.post_physics), the cold
  // rows waited for only now
  copy_async4_wait();
  float cv[kColdRows];
#pragma unroll
  for (int i = 0; i < kColdRows; ++i) cv[i] = my_cold[i * kThreadBlock];
  const float shaping[6] = {cv[3], cv[4], cv[5], cv[6], cv[7], cv[8]};
  const VssOutcome out =
      vss_outcome(p, ball, r[0].x, r[0].y, r[0].vx, r[0].vy, wl0, wr0, cv[0], cv[1], cv[2], shaping);
  const bool done = out.done;

  auto npos = [&](float v) { return clampf(v / p.max_pos, -p.nbnd, p.nbnd); };
  auto nv = [&](float v) { return clampf(v / p.max_v, -p.nbnd, p.nbnd); };
  auto nw = [&](float v) { return clampf(v / p.max_w_rad, -p.nbnd, p.nbnd); };
  // the obs rows from row o: ball, then each robot (blues with their
  // heading's sin, cos)
  auto write_obs = [&](int o, bool carried_trig) {
    LD(obs_out, o++) = npos(ball.x);
    LD(obs_out, o++) = npos(ball.y);
    LD(obs_out, o++) = nv(ball.vx);
    LD(obs_out, o++) = nv(ball.vy);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      LD(obs_out, o++) = npos(r[q].x);
      LD(obs_out, o++) = npos(r[q].y);
      if (q < nb) {
        float c = r[q].c, sn = r[q].s;
        if (!carried_trig) cos_sin(r[q].th, c, sn);
        LD(obs_out, o++) = sn;
        LD(obs_out, o++) = c;
      }
      LD(obs_out, o++) = nv(r[q].vx);
      LD(obs_out, o++) = nv(r[q].vy);
      LD(obs_out, o++) = nw(r[q].w);
    }
  };
  const int obs_size = 4 + 7 * nb + 5 * (N - nb);

  // final (pre-reset) observation; heading trig from the substep carry
  if (emit_final) write_obs(obs_size, true);

  // ---- done envs only: spawn placement (envs/spawn.place_separated, first
  // valid), the reset headings (slots NSP + [0, N), their own Philox
  // blocks: the words are the OU draw's where the two share a block), the
  // OU rows zeroed; then the auto-reset select
  if (done) {
    PhiloxKey pk{};
    if constexpr (RNG_KERNEL) pk = philox_load_key(key, env_base);
    float px[1 + N], py[1 + N];
#pragma unroll
    for (int i = 0; i < 1 + N; ++i) {
      float u[2 * K];  // candidate k's uniforms: slots i*2K + k and i*2K + K + k
      if constexpr (RNG_KERNEL) {
        philox_uniforms<2 * K>(pk, (uint32_t)b, (uint32_t)(i * 2 * K / 4), u);
      } else {
#pragma unroll
        for (int k = 0; k < 2 * K; ++k) u[k] = LD(sp_in, i * 2 * K + k);
      }
      float sel_x = p.x_lo + u[0] * p.x_span;  // none valid: candidate 0
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
    float th_u[N];
    if constexpr (RNG_KERNEL) philox_slot_range<NSP>(pk, (uint32_t)b, th_u);
    ball = VssBall{px[0], py[0], p.r_ball, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < N; ++q) {
      if constexpr (!RNG_KERNEL) th_u[q] = LD(th_in, q);
      r[q].x = px[1 + q];
      r[q].y = py[1 + q];
      r[q].th = th_u[q] * p.two_pi;
      r[q].vx = r[q].vy = r[q].w = 0.0f;
      LD(st_out, 7 + 6 * N + q) = 0.0f;
      LD(st_out, 7 + 7 * N + q) = 0.0f;
    }
  }


  // ---- outputs
  LD(st_out, 0) = ball.x;
  LD(st_out, 1) = ball.y;
  LD(st_out, 2) = ball.z;
  LD(st_out, 3) = ball.vx;
  LD(st_out, 4) = ball.vy;
  LD(st_out, 5) = ball.vz;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    LD(st_out, 6 + q) = r[q].x;
    LD(st_out, 6 + N + q) = r[q].y;
    LD(st_out, 6 + 2 * N + q) = r[q].th;
    LD(st_out, 6 + 3 * N + q) = r[q].vx;
    LD(st_out, 6 + 4 * N + q) = r[q].vy;
    LD(st_out, 6 + 5 * N + q) = r[q].w;
  }
  LD(st_out, 6 + 6 * N) = done ? 0.0f : out.steps_new;
  LD(st_out, 7 + 8 * N) = done ? 0.0f : out.potential;
  LD(st_out, 8 + 8 * N) = done ? 0.0f : 1.0f;
  write_obs(0, false);
  LD(aux_out, 0) = out.reward;
  LD(aux_out, 1) = out.goal ? 1.0f : 0.0f;
  LD(aux_out, 2) = out.trunc ? 1.0f : 0.0f;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    LD(st_out, 9 + 8 * N + q) = done ? 0.0f : out.shaping[q];
    LD(aux_out, 3 + q) = out.shaping[q];
  }
#undef LD
}

template <int N, bool RNG_KERNEL>
__global__ void __launch_bounds__(kThreadBlock)
    vss_thread_kernel(const VssParams p, int nb, bool emit_final, bool exact_trig, VSS_THREAD_PARAMS) {
  vss_thread_step<N, RNG_KERNEL>(p, nb, emit_final, exact_trig, VSS_THREAD_ARGS);
}

// the same step with its registers capped for MIN_BLOCKS blocks per SM
template <int N, bool RNG_KERNEL, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreadBlock, MIN_BLOCKS)
    vss_thread_kernel_bounded(const VssParams p, int nb, bool emit_final, bool exact_trig, VSS_THREAD_PARAMS) {
  vss_thread_step<N, RNG_KERNEL>(p, nb, emit_final, exact_trig, VSS_THREAD_ARGS);
}
#undef VSS_THREAD_PARAMS
#undef VSS_THREAD_ARGS

template <int N, bool CAPPED>
cudaError_t launch_thread(int nb, int emit_final, int rng_kernel, int exact_trig, const VssParams& p,
                          const float* st, const float* act, const float* ou, const float* sp, const float* th,
                          const long long* key, uint32_t env_base, float* st_out, float* obs_out, float* aux_out,
                          int B, cudaStream_t stream) {
  const dim3 grid((B + kThreadBlock - 1) / kThreadBlock), block(kThreadBlock);
  constexpr int kMin = CAPPED ? kCappedMinBlocks : kThreadMinBlocks<N>;
  if constexpr (kMin > 0) {
    if (rng_kernel)
      vss_thread_kernel_bounded<N, true, kMin><<<grid, block, 0, stream>>>(
          p, nb, emit_final, exact_trig, st, act, ou, sp, th, key, env_base, st_out, obs_out, aux_out, B);
    else
      vss_thread_kernel_bounded<N, false, kMin><<<grid, block, 0, stream>>>(
          p, nb, emit_final, exact_trig, st, act, ou, sp, th, key, env_base, st_out, obs_out, aux_out, B);
  } else {
    if (rng_kernel)
      vss_thread_kernel<N, true><<<grid, block, 0, stream>>>(p, nb, emit_final, exact_trig, st, act, ou, sp, th,
                                                             key, env_base, st_out, obs_out, aux_out, B);
    else
      vss_thread_kernel<N, false><<<grid, block, 0, stream>>>(p, nb, emit_final, exact_trig, st, act, ou, sp, th,
                                                              key, env_base, st_out, obs_out, aux_out, B);
  }
  return cudaGetLastError();
}

}  // namespace
