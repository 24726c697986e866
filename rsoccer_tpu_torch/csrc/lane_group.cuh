// The lane group: one env on G consecutive lanes of a warp, 256 threads per
// block, G a compile-time width (LaneGroup<G>):
//   G = 8:  4 envs per warp, 32 per block: K1 at 3v3, K2 at N = 6 (one
//           robot per lane, vss_world.cuh) and the SSL world (ssl_world.cuh:
//           K4, K6), which use the 8-lane names kGroup, kEnvsPerBlock,
//           kTileStride below;
//   G = 16: 2 envs per warp, 16 per block: K1 at 5v5, K2 at N = 10 (one
//           robot per lane, 16 lanes for 10 robots, the ball and the env's
//           scalars).
#pragma once
#include <cuda_runtime.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;  // every group kernel's block

// ---- staging: a block's envs pass through shared memory in (row, env)
// tiles, so each global row of the block's envs is one coalesced access
// (128 bytes at 32 envs, two full 32-byte sectors at 16).  A row stride of
// E + 32 / G floats (E envs per block, G = 256 / E lanes per env: 36 at
// G = 8, 18 at G = 16) puts the G lanes of each of a warp's 32 / G envs,
// reading rows base + k, on 32 distinct banks: k (32 / G) mod 32 at G = 8,
// 18 k = 2 (9 k mod 16) mod 32 at G = 16, each plus the env's offset.
__host__ __device__ constexpr int tile_stride(int envs) { return envs + 32 / (kThreads / envs); }

template <int G>
struct LaneGroup {
  static_assert(G == 8 || G == 16, "8 or 16 lanes per env");
  static constexpr int kEnvsPerBlock = kThreads / G;
  static constexpr int kTileStride = tile_stride(kEnvsPerBlock);

  // this lane's group's G bits of a warp-wide ballot, from bit 0
  static __device__ __forceinline__ unsigned own_bits(unsigned ballot) {
    return (ballot >> (threadIdx.x & (32u - G))) & ((1u << G) - 1u);
  }
};

// the 8-lane group's (the SSL world, K1 at 3v3, K2 at N = 6)
constexpr int kGroup = 8;
constexpr int kEnvsPerBlock = LaneGroup<kGroup>::kEnvsPerBlock;
constexpr int kTileStride = LaneGroup<kGroup>::kTileStride;

// rows [0, ROWS) of the (rows, B) array `src` for the block's E envs into
// tile rows [row0, row0 + ROWS); envs past B read as 0
template <int ROWS, int E = kEnvsPerBlock>
__device__ __forceinline__ void load_rows(float* tile, int row0, const float* __restrict__ src, int b0, int B) {
  constexpr int kStride = tile_stride(E);
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * E; i += kThreads) {
    const int row = i / E, e = i % E;
    const int b = b0 + e;
    tile[(row0 + row) * kStride + e] = b < B ? src[(size_t)row * B + b] : 0.0f;
  }
}

// tile rows [row0, row0 + ROWS) into rows [0, ROWS) of `dst`; envs past B
// are not stored
template <int ROWS, int E = kEnvsPerBlock>
__device__ __forceinline__ void store_rows(const float* tile, int row0, float* __restrict__ dst, int b0, int B) {
  constexpr int kStride = tile_stride(E);
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * E; i += kThreads) {
    const int row = i / E, e = i % E;
    const int b = b0 + e;
    if (b < B) dst[(size_t)row * B + b] = tile[(row0 + row) * kStride + e];
  }
}

// load_rows with every load of the thread in flight before the first
// store: the SSL group kernels' staging (1 us faster there at 8192 envs;
// the VSS physics kernel measured slower with it, PERF.md section 6)
template <int ROWS>
__device__ __forceinline__ void load_rows_in_flight(float* tile, int row0, const float* __restrict__ src, int b0,
                                                    int B) {
  constexpr int kIters = (ROWS * kEnvsPerBlock + kThreads - 1) / kThreads;
  const int e = threadIdx.x % kEnvsPerBlock;
  const bool in = b0 + e < B;
  float v[kIters];
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int row = threadIdx.x / kEnvsPerBlock + j * (kThreads / kEnvsPerBlock);
    v[j] = (row < ROWS && in) ? src[(size_t)row * B + b0 + e] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int row = threadIdx.x / kEnvsPerBlock + j * (kThreads / kEnvsPerBlock);
    if (row < ROWS) tile[(row0 + row) * kTileStride + e] = v[j];
  }
}
