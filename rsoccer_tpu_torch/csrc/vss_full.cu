// Fused VSS-v0 env step: the whole step for one env, on a group of lanes
// (vss_full_kernel, here: 3v3 on 8 lanes, 5v5 on 16) or on one thread
// (vss_thread_kernel, vss_thread.cu: every team size from 1v0 to 5v5).
//
// Replaces the TPU kernel rsoccer_tpu/ops/pallas_vss_full.py:142
// (make_pallas_vss_full_step, body `compute` at :243).  Per env it runs:
// OU update -> agent action over robot 0 -> wheel conversion with the
// deadzone -> 5 physics substeps (vss_world.cuh: reduced-range Taylor
// heading rotation, pair contacts, robot wall clamp, ball friction and
// vertical axis, ball-robot contacts, walls with goal pockets) -> reward
// cascade -> shaping accumulators, truncation -> on done envs only, spawn
// first-valid placement -> auto-reset select -> observation.
//
// Layout: every operand is a flat row-major (rows, B) f32 array read as
// p[row * B + b], the TPU kernel's (S, B) state layout byte for byte.
//
// The group kernel (vss_full_kernel<NB, NY, G>): a block of 256 threads
// steps 256 / G envs (32 at 3v3, 16 at 5v5): each row of the block's envs
// passes through a shared-memory tile in one coalesced access (128 bytes,
// or two full 32-byte sectors at 16 envs), and each input row is read once
// and each output row written once.  Work split inside an env's group of G
// lanes (vss_world.cuh): lane k < N owns robot k (its OU noise, wheels,
// substep chain, state and obs rows); lane l evaluates robot pairs l,
// l + G, ... (2 of 15 at 3v3, 3 of 45 at 5v5); every lane carries the
// ball; lane N writes the ball's rows, lane N + 1 the env's scalars and the
// aux rows.  The reward cascade runs on every lane (each needs `done`).  A
// done env places its N + 1 entities in order with candidate k on lane
// k < 8 (lanes 8..15 at 5v5 vote no): the first valid candidate is the
// lowest set bit of the group's G bits of a warp ballot.  Shared memory per
// block: the tile and the exchange slots share one buffer, the slots the
// larger: 24,576 bytes at 3v3 (32 envs x 48 float4), 31,744 at 5v5 (16 x
// 124), under the 48 KB static limit; two blocks per SM at 3v3 and four
// at 5v5 by the launch bounds (kVssMinBlocks, vss_world.cuh).
//
// What bounds it: at B = 8192 the 3v3 step moves ~5.8 MB (state in/out,
// obs, aux, actions), about 1.7 us of HBM time, the 5v5 step 8.7 MB, 2.6
// us.  One thread per env ran a long dependent chain with 256 warps on
// 132 SMs (at 5v5 10 robots, 45 pairs and 10 ball contacts per substep in
// 254-255 registers): latency bound.  A group of lanes per env gives 2048
// warps at 3v3 (8 lanes) and 4096 at 5v5 (16 lanes), and cuts each lane's
// chain per substep to one robot, two or three pairs, its partner sums and
// the ball's, each pair still evaluated once.  The reset work (the spawn
// Philox blocks, (N + 1) x 8 candidates, the theta draw) runs only on done
// envs.  In the kernel-RNG variant the group draws the Philox blocks that
// hold its OU slots once, one per lane (7 at 3v3, 11 at 5v5), and shares
// the words.  From large batches, where the card is full, the lanes issue
// more instructions per env than one thread does (the replicated ball
// work and the exchanges), and the wrapper launches the one-thread kernel
// instead (ops/vss_full.GROUP_MAX_ENVS, measured in PERF.md).
//
// The one-thread kernel, every team size from 1v0 to 5v5 and 3v3 and 5v5
// above their crossovers, is in vss_thread.cu; both share vss_step.cuh.
//
// Numerics: the reduced-range Taylor rotation and the rsqrt normals of the
// TPU kernel are kept (the 5e-5 kernel-vs-plain tolerance was set against
// them), and beyond the Taylor bound, exact cosf/sinf each substep, as the
// TPU kernel's fallback (vss_world.cuh, ExactRsqrt).  Built without
// --use_fast_math and with --fmad=false, so every other multiply and add
// rounds as the plain version's separate ops do.
#include "vss_step.cuh"

namespace {

template <int NB, int NY, int G, bool EMIT_FINAL, bool RNG_KERNEL, class Pol>
__global__ void __launch_bounds__(kThreads, kVssMinBlocks<G>)
    vss_full_kernel(const VssParams p, const float* __restrict__ st, const float* __restrict__ act,
                    const float* __restrict__ ou_in, const float* __restrict__ sp_in,
                    const float* __restrict__ th_in, const long long* __restrict__ key, uint32_t env_base,
                    float* __restrict__ st_out, float* __restrict__ obs_out, float* __restrict__ aux_out,
                    int B) {
  constexpr int N = NB + NY;
  using LG = LaneGroup<G>;
  using L = VssLayout<N, G>;
  constexpr int E = LG::kEnvsPerBlock;
  static_assert(K <= G, "spawn candidate k sits on lane k");
  static_assert(N + 2 <= G, "lane N writes the ball's rows, lane N + 1 the env's scalars");
  constexpr int S = 15 + 8 * N;               // state rows
  constexpr int NSP = (1 + N) * 2 * K;        // spawn uniforms: slots [0, NSP)
  constexpr int OU1 = NSP + N, OU2 = NSP + 3 * N;  // OU u1, u2 slots (theta: NSP + r)
  static_assert(OU1 % 2 == 0, "a robot's two OU slots share a Philox block");
  constexpr int OU_BLK0 = OU1 / 4, OU_NBLK = (OU2 + 2 * N - 1) / 4 - OU_BLK0 + 1;  // blocks of the OU slots
  static_assert(OU_NBLK <= G, "one OU Philox block per lane");
  constexpr int OBS = 4 + 7 * NB + 5 * NY;
  constexpr int OBS_ROWS = OBS * (EMIT_FINAL ? 2 : 1);
  constexpr int IN_ROWS = S + 2 + (RNG_KERNEL ? 0 : 2 * N);  // state, action, OU normals
  constexpr int OUT_ROWS = S + OBS_ROWS + 9;                  // state, obs, aux
  constexpr int TILE_FLOATS = (IN_ROWS > OUT_ROWS ? IN_ROWS : OUT_ROWS) * LG::kTileStride;
  constexpr int XCHG_FLOATS = E * L::kSlots * 4;
  // the row tile (before and after the substeps) and the groups' exchange
  // slots (during them) share one buffer: at 5v5 (G = 16) 31,744 bytes of
  // slots against a 16,704-byte tile (232 output rows with emit_final)
  __shared__ float4 buf[((TILE_FLOATS > XCHG_FLOATS ? TILE_FLOATS : XCHG_FLOATS) + 3) / 4];
  __shared__ int4 desc[L::kDescs];
  float* tile = reinterpret_cast<float*>(buf);

  const int k = threadIdx.x % G;  // lane in the env's group
  const int e = threadIdx.x / G;  // env in the block
  const int b0 = blockIdx.x * E;
  const int b = b0 + e;
  const bool live = b < B;  // lanes past B take part in every exchange, store nothing
  const int rr = k < N ? k : 0;  // lanes past the robots carry robot 0
  float4* grp = buf + e * L::kSlots;
#define T(row) tile[(row) * LG::kTileStride + e]

  // ---- stage in
  load_rows<S, E>(tile, 0, st, b0, B);
  load_rows<2, E>(tile, S, act, b0, B);
  if constexpr (!RNG_KERNEL) load_rows<2 * N, E>(tile, S + 2, ou_in, b0, B);
  if (threadIdx.x < L::kDescs) desc[threadIdx.x] = pair_desc<N>(threadIdx.x);
  __syncthreads();

  VssRobot r;
  r.x = T(6 + rr);
  r.y = T(6 + N + rr);
  r.th = T(6 + 2 * N + rr);
  r.vx = T(6 + 3 * N + rr);
  r.vy = T(6 + 4 * N + rr);
  r.w = T(6 + 5 * N + rr);
  VssBall ball{T(0), T(1), T(2), T(3), T(4), T(5)};
  const float steps = T(6 + 6 * N);
  float ou0 = T(7 + 6 * N + rr), ou1 = T(7 + 7 * N + rr);  // wheel 0, wheel 1
  const float ball_pot = T(7 + 8 * N);
  const float has_pot = T(8 + 8 * N);
  float shaping[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) shaping[q] = T(9 + 8 * N + q);
  const float a0 = T(S), a1 = T(S + 1);
  float n0, n1;  // OU normals of this robot's two wheels
  if constexpr (!RNG_KERNEL) {
    n0 = T(S + 2 + rr);
    n1 = T(S + 2 + N + rr);
  }
  __syncthreads();  // the buffer now takes the groups' exchange slots

  // ---- in-kernel OU normals.  The env's OU slots span OU_NBLK Philox
  // blocks: lane m draws block OU_BLK0 + m and posts it to the group.
  PhiloxKey pk{};
  if constexpr (RNG_KERNEL) {
    pk = philox_load_key(key, env_base);
    uint4* words = reinterpret_cast<uint4*>(grp);
    if (k < OU_NBLK) words[k] = philox_block(pk, (uint32_t)b, (uint32_t)(OU_BLK0 + k));
    __syncwarp();
    const int s1 = OU1 + 2 * rr, s2 = OU2 + 2 * rr;  // wheel w at s1 + w, s2 + w
    const uint4 w1 = words[s1 / 4 - OU_BLK0];
    const uint4 w2 = words[s2 / 4 - OU_BLK0];
    n0 = box_muller(philox_uniform(philox_word(w1, s1 % 4)), philox_uniform(philox_word(w2, s2 % 4)));
    n1 = box_muller(philox_uniform(philox_word(w1, s1 % 4 + 1)), philox_uniform(philox_word(w2, s2 % 4 + 1)));
    __syncwarp();  // the substeps overwrite the slots next
  }

  // ---- OU update (envs/ou.ou_update: mu = 0, sigma = 0.5)
  ou0 = ou0 + p.ou_theta * (0.0f - ou0) * p.dt + p.ou_sig_sqdt * n0;
  ou1 = ou1 + p.ou_theta * (0.0f - ou1) * p.dt + p.ou_sig_sqdt * n1;

  // ---- actions -> wheels: the agent's action replaces robot 0's OU rows
  const float wl0 = to_wheel(a0, p), wr0 = to_wheel(a1, p);
  {
    const float l = clampf(k == 0 ? wl0 : to_wheel(ou0, p), -p.max_wheel, p.max_wheel);
    const float rw = clampf(k == 0 ? wr0 : to_wheel(ou1, p), -p.max_wheel, p.max_wheel);
    r.v_tgt = p.wheel_r * (l + rw) / 2.0f;
    r.w_tgt = p.wheel_r * (rw - l) / p.two_half_axle;
  }

  // ---- physics substeps; cos/sin of the heading carried across substeps
  r.c = cosf(r.th);
  r.s = sinf(r.th);
#pragma unroll 1  // kept rolled: the unrolled body would be 5x the code
  for (int sub = 0; sub < kSubsteps; ++sub) vss_substep<Pol, N, G>(p, k, grp, desc, r, ball);
  __syncthreads();  // the buffer now takes the output rows

  // ---- reward & termination cascade (envs/vss.post_physics), every lane
  const float x0 = __shfl_sync(kFullMask, r.x, 0, G), y0 = __shfl_sync(kFullMask, r.y, 0, G);
  const float vx0 = __shfl_sync(kFullMask, r.vx, 0, G), vy0 = __shfl_sync(kFullMask, r.vy, 0, G);
  const VssOutcome out = vss_outcome(p, ball, x0, y0, vx0, vy0, wl0, wr0, steps, ball_pot, has_pot, shaping);
  const bool done = out.done;

  auto npos = [&](float v) { return clampf(v / p.max_pos, -p.nbnd, p.nbnd); };
  auto nv = [&](float v) { return clampf(v / p.max_v, -p.nbnd, p.nbnd); };
  auto nw = [&](float v) { return clampf(v / p.max_w_rad, -p.nbnd, p.nbnd); };
  // this robot's obs rows (from tile row `base`), then the ball's
  auto robot_obs = [&](int base, float sn, float cs) {
    int row = base + 4 + (k < NB ? 7 * k : 7 * NB + 5 * (k - NB));
    T(row++) = npos(r.x);
    T(row++) = npos(r.y);
    if (k < NB) {
      T(row++) = sn;
      T(row++) = cs;
    }
    T(row++) = nv(r.vx);
    T(row++) = nv(r.vy);
    T(row++) = nw(r.w);
  };
  auto ball_obs = [&](int base) {
    T(base + 0) = npos(ball.x);
    T(base + 1) = npos(ball.y);
    T(base + 2) = nv(ball.vx);
    T(base + 3) = nv(ball.vy);
  };

  // final (pre-reset) observation; heading trig from the substep carry
  if constexpr (EMIT_FINAL) {
    if (k < N) robot_obs(S + OBS, r.s, r.c);
    else if (k == N) ball_obs(S + OBS);
  }

  // ---- done envs only: spawn placement (envs/spawn.place_separated, first
  // valid) and the reset headings; then the auto-reset select.  Candidate
  // k sits on lane k < K; lanes K..G-1 (at G = 16) vote with ok = false.
  const bool reset = done && live;
  const unsigned reset_mask = __ballot_sync(kFullMask, reset);
  if (reset) {
    float th_u;
    if constexpr (RNG_KERNEL) th_u = philox_slot_uniform(pk, (uint32_t)b, NSP + rr);
    else th_u = th_in[(size_t)rr * B + b];
    float px[1 + N], py[1 + N];
#pragma unroll
    for (int i = 0; i < 1 + N; ++i) {
      float cx = 0.0f, cy = 0.0f;
      bool ok = false;
      if (k < K) {
        float ux, uy;  // candidate k's uniforms: slots i*2K + k and i*2K + K + k
        if constexpr (RNG_KERNEL) {
          ux = philox_slot_uniform(pk, (uint32_t)b, i * 2 * K + k);
          uy = philox_slot_uniform(pk, (uint32_t)b, i * 2 * K + K + k);
        } else {
          ux = sp_in[(size_t)(i * 2 * K + k) * B + b];
          uy = sp_in[(size_t)(i * 2 * K + K + k) * B + b];
        }
        cx = p.x_lo + ux * p.x_span;
        cy = p.y_lo + uy * p.y_span;
        ok = true;
#pragma unroll
        for (int q = 0; q < i; ++q) {
          const float ddx = cx - px[q];
          const float ddy = cy - py[q];
          ok = ok && (ddx * ddx + ddy * ddy) >= p.min_d2;
        }
      }
      const unsigned valid = LG::own_bits(__ballot_sync(reset_mask, ok));
      const int first = valid ? __ffs(valid) - 1 : 0;  // none valid: candidate 0
      px[i] = __shfl_sync(reset_mask, cx, first, G);
      py[i] = __shfl_sync(reset_mask, cy, first, G);
    }
    ball = VssBall{px[0], py[0], p.r_ball, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < N; ++i) {  // robot rr's point: a select, not an indexed (local-memory) load
      if (i == rr) {
        r.x = px[1 + i];
        r.y = py[1 + i];
      }
    }
    r.th = th_u * p.two_pi;
    r.vx = r.vy = r.w = 0.0f;
  }

  // ---- outputs into the tile: robot lanes their rows, lane N the ball's,
  // lane N + 1 the env's scalars and aux rows
  if (k < N) {
    T(6 + k) = r.x;
    T(6 + N + k) = r.y;
    T(6 + 2 * N + k) = r.th;
    T(6 + 3 * N + k) = r.vx;
    T(6 + 4 * N + k) = r.vy;
    T(6 + 5 * N + k) = r.w;
    T(7 + 6 * N + k) = done ? 0.0f : ou0;
    T(7 + 7 * N + k) = done ? 0.0f : ou1;
    robot_obs(S, sinf(r.th), cosf(r.th));
  } else if (k == N) {
    T(0) = ball.x;
    T(1) = ball.y;
    T(2) = ball.z;
    T(3) = ball.vx;
    T(4) = ball.vy;
    T(5) = ball.vz;
    ball_obs(S);
  } else if (k == N + 1) {
    T(6 + 6 * N) = done ? 0.0f : out.steps_new;
    T(7 + 8 * N) = done ? 0.0f : out.potential;
    T(8 + 8 * N) = done ? 0.0f : 1.0f;
    const int a = S + OBS_ROWS;
    T(a + 0) = out.reward;
    T(a + 1) = out.goal ? 1.0f : 0.0f;
    T(a + 2) = out.trunc ? 1.0f : 0.0f;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      T(9 + 8 * N + q) = done ? 0.0f : out.shaping[q];
      T(a + 3 + q) = out.shaping[q];
    }
  }
#undef T
  __syncthreads();

  // ---- stage out
  store_rows<S, E>(tile, 0, st_out, b0, B);
  store_rows<OBS_ROWS, E>(tile, S, obs_out, b0, B);
  store_rows<9, E>(tile, S + OBS_ROWS, aux_out, b0, B);
}

template <int NB, int NY, int G, class Pol>
cudaError_t launch(int emit_final, int rng_kernel, const VssParams& p, const float* st, const float* act,
                   const float* ou, const float* sp, const float* th, const long long* key, uint32_t env_base,
                   float* st_out, float* obs_out, float* aux_out, int B, cudaStream_t stream) {
  constexpr int E = LaneGroup<G>::kEnvsPerBlock;
  const dim3 grid((B + E - 1) / E), block(kThreads);
#define VSS_LAUNCH(EF, RK)                                                                                   \
  vss_full_kernel<NB, NY, G, EF, RK, Pol><<<grid, block, 0, stream>>>(p, st, act, ou, sp, th, key, env_base, \
                                                                       st_out, obs_out, aux_out, B)
  if (emit_final && rng_kernel) VSS_LAUNCH(true, true);
  else if (emit_final) VSS_LAUNCH(true, false);
  else if (rng_kernel) VSS_LAUNCH(false, true);
  else VSS_LAUNCH(false, false);
#undef VSS_LAUNCH
  return cudaGetLastError();
}

__global__ void philox_words_kernel(const long long* __restrict__ key, uint32_t env_base, uint32_t* __restrict__ out,
                                    int n_blk, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const PhiloxKey k = philox_load_key(key, env_base);
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

// The version of the entries' arguments: 1 since every entry that draws
// takes env_base (the global index of column 0) before B.
int kernels_abi_version() { return 1; }

// One fused step on the group kernel: 3v3 (VSS-v0) on 8 lanes per env,
// 5v5 on 16; exact_trig picks the turn (ExactRsqrt beyond the Taylor
// bound).  Returns a cudaError_t (cudaErrorInvalidValue for another team
// size).
int vss_full_step(int n_blue, int n_yellow, int emit_final, int rng_kernel, int exact_trig, const VssParams* p,
                  const float* st, const float* act, const float* ou, const float* sp, const float* th,
                  const long long* key, float* st_out, float* obs_out, float* aux_out, int env_base, int B,
                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define VSS_GROUP(NB, NY, G)                                                                                       \
  if (n_blue == NB && n_yellow == NY) {                                                                            \
    if (exact_trig)                                                                                                \
      return launch<NB, NY, G, ExactRsqrt>(emit_final, rng_kernel, *p, st, act, ou, sp, th, key, (uint32_t)env_base, \
                                           st_out, obs_out, aux_out, B, s);                                         \
    return launch<NB, NY, G, TaylorRsqrt>(emit_final, rng_kernel, *p, st, act, ou, sp, th, key, (uint32_t)env_base,  \
                                          st_out, obs_out, aux_out, B, s);                                          \
  }
  VSS_GROUP(3, 3, 8)
  VSS_GROUP(5, 5, 16)
#undef VSS_GROUP
  return (int)cudaErrorInvalidValue;
}

// Raw Philox words of blocks [0, n_blk) for columns [0, B), global env
// indices from env_base: out is (4 n_blk, B) u32 — the debug entry that
// holds the device stream to the torch one.
int philox_words(const long long* key, uint32_t* out, int n_blk, int env_base, int B, void* stream) {
  const dim3 grid((B + 127) / 128), block(128);
  philox_words_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(key, (uint32_t)env_base, out, n_blk, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
