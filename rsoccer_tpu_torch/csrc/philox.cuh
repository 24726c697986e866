// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC'11) — the device twin of rsoccer_tpu_torch/ops/philox.py.
//
// One mapping for every random word the port draws:
//   (key[2], step, env, slot) -> u32
//   counter = (env, slot / 4, step_lo, step_hi), word = slot % 4
// where env is the GLOBAL env index: env_base + the kernel's own column.
// env_base is 0 unless the batch is one shard of a larger one
// (rsoccer_tpu_torch/parallel/): shard r of W then draws the words that
// columns [r B, (r + 1) B) of the unsharded batch draw.
// Uniforms are the top 24 bits times 2^-24 (exact in f32); normals are
// Box-Muller, cos branch, with u1 clamped at 1e-7.
#pragma once
#include <stdint.h>

struct PhiloxKey {
  uint32_t k0, k1;
  uint32_t step_lo, step_hi;
  uint32_t env_base;  // the first column's global env index
};

// key tensor layout: int64 [k0, k1, step] on the device
__device__ __forceinline__ PhiloxKey philox_load_key(const long long* key, uint32_t env_base) {
  PhiloxKey k;
  k.k0 = (uint32_t)key[0];
  k.k1 = (uint32_t)key[1];
  const unsigned long long step = (unsigned long long)key[2];
  k.step_lo = (uint32_t)step;
  k.step_hi = (uint32_t)(step >> 32);
  k.env_base = env_base;
  return k;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the 4 words of slots [4*blk, 4*blk + 4) of column `env` (global env
// index env_base + env)
__device__ __forceinline__ uint4 philox_block(const PhiloxKey& k, uint32_t env, uint32_t blk) {
  return philox4x32_10(make_uint4(k.env_base + env, blk, k.step_lo, k.step_hi), k.k0, k.k1);
}

__device__ __forceinline__ float philox_uniform(uint32_t w) {
  return (float)(w >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// word i of a block (i in 0..3)
__device__ __forceinline__ uint32_t philox_word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// the uniform of slot `slot` of column `env`: one block drawn for one word
__device__ __forceinline__ float philox_slot_uniform(const PhiloxKey& k, uint32_t env, int slot) {
  return philox_uniform(philox_word(philox_block(k, env, (uint32_t)(slot / 4)), slot % 4));
}

__device__ __forceinline__ float box_muller(float u1, float u2) {
  u1 = fmaxf(u1, 1e-7f);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.2831855f * u2);
}

// uniforms of slots [4*blk0, 4*blk0 + NS) into out (NS a multiple of 4
// or the tail of the draw; slots past NS are dropped)
template <int NS>
__device__ __forceinline__ void philox_uniforms(const PhiloxKey& k, uint32_t env, uint32_t blk0,
                                                float (&out)[NS]) {
#pragma unroll
  for (int q = 0; q < (NS + 3) / 4; ++q) {
    const uint4 w = philox_block(k, env, blk0 + q);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * q + j < NS) out[4 * q + j] = philox_uniform(ws[j]);
  }
}

// uniforms of slots [FIRST, FIRST + NS) into out, each Philox block that
// holds them drawn once (its words outside the range dropped): the same
// words as any other draw of those slots
template <int FIRST, int NS>
__device__ __forceinline__ void philox_slot_range(const PhiloxKey& k, uint32_t env, float (&out)[NS]) {
#pragma unroll
  for (int blk = FIRST / 4; blk <= (FIRST + NS - 1) / 4; ++blk) {
    const uint4 w = philox_block(k, env, (uint32_t)blk);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * blk + j >= FIRST && 4 * blk + j < FIRST + NS) out[4 * blk + j - FIRST] = philox_uniform(ws[j]);
  }
}
