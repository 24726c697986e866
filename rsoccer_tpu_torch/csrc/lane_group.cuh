// The lane group: one env on kGroup = 8 consecutive lanes of a warp (4
// envs per warp), 32 envs per block.  Shared by the cooperative VSS world
// (vss_world.cuh: K1, K2) and SSL world (ssl_world.cuh: K4, K6).
#pragma once
#include <cuda_runtime.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kGroup = 8;          // lanes per env
constexpr int kEnvsPerBlock = 32;  // a block's envs: one 128-byte segment of each row
constexpr int kThreads = kEnvsPerBlock * kGroup;

// ---- staging: a block's envs pass through shared memory in (row, env)
// tiles, so each global row of kEnvsPerBlock envs is one coalesced 128-byte
// access.  A row stride of 36 floats puts a group's 8 lanes, reading rows
// base + k of 4 neighbouring envs, on 32 distinct banks.
constexpr int kTileStride = kEnvsPerBlock + 4;

// rows [0, ROWS) of the (rows, B) array `src` for the block's envs into
// tile rows [row0, row0 + ROWS); envs past B read as 0
template <int ROWS>
__device__ __forceinline__ void load_rows(float* tile, int row0, const float* __restrict__ src, int b0, int B) {
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kEnvsPerBlock; i += kThreads) {
    const int row = i / kEnvsPerBlock, e = i % kEnvsPerBlock;
    const int b = b0 + e;
    tile[(row0 + row) * kTileStride + e] = b < B ? src[(size_t)row * B + b] : 0.0f;
  }
}

// tile rows [row0, row0 + ROWS) into rows [0, ROWS) of `dst`; envs past B
// are not stored
template <int ROWS>
__device__ __forceinline__ void store_rows(const float* tile, int row0, float* __restrict__ dst, int b0, int B) {
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kEnvsPerBlock; i += kThreads) {
    const int row = i / kEnvsPerBlock, e = i % kEnvsPerBlock;
    const int b = b0 + e;
    if (b < B) dst[(size_t)row * B + b] = tile[(row0 + row) * kTileStride + e];
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
