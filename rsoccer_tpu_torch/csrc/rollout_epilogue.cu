// The rollout loop's per-step bookkeeping in one launch a step
// (batch/rollout.make_rollout_fn on the card), and its finishing sum once
// a call.  It replaces no TPU kernel: the JAX package's rollout scans the
// step inside one compiled program, where XLA fuses these element-wise
// ops and sums into the step; run eagerly they were ~24 launches a step
// (done, the two accumulators, four sums with their memsets, four
// selects, the adds of the running sums).
//
// Per env a step reads reward, term, trunc and the two episode
// accumulators and writes the accumulators, out of place, with the plain
// loop's float32 operations, so the carries are its bits:
//     er = ep_ret + r;  el = ep_len + 1;  done = term | trunc;
//     ep_ret' = done ? 0 : er;  ep_len' = done ? 0 : el.
// ~22 bytes per env: the kernel is bound by device memory (7 us at 1M envs
// at 3.35 TB/s), so it moves each byte once, in 16-byte loads where the
// pointers allow (a scalar tail past the last whole vector), over a fixed
// grid that fills the card once with a grid-stride loop.
//
// The four sums (reward, done, done ? er : 0, done ? el : 0) are taken in
// float64: per thread, then over the warp by shuffles and over the block
// through shared memory, in a fixed order.  Each block adds its partials
// to its own slot of a (4, kMaxSlots) float64 scratch that lives for the
// whole call (the first step of a call stores instead of adding, so the
// scratch needs no memset); no atomics, so two runs give the same bits.
// The finishing kernel sums the grid's G slots in a fixed order into the
// metrics' dtypes: float32 reward, return and length sums, an int64
// episode count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the step's most blocks, each with its slot (ops/rollout_epilogue.SLOTS): one wave of
// 256-thread blocks on 132 SMs
constexpr int kMaxSlots = 1024;
constexpr int kFinishThreads = 256;

// G, the step's grid at B envs: a vector of 4 envs a thread, at most one wave.
int slots(int B) {
  const long long g = ((long long)B + 4 * kThreads - 1) / (4 * kThreads);
  return g < 1 ? 1 : (g > kMaxSlots ? kMaxSlots : (int)g);
}

struct Sums {
  double reward, done, ret, len;
};

__device__ __forceinline__ void one_env(float r, bool d, float ret_in, float len_in, float& ret_out,
                                        float& len_out, Sums& s) {
  const float er = ret_in + r;
  const float el = len_in + 1.0f;
  ret_out = d ? 0.0f : er;
  len_out = d ? 0.0f : el;
  s.reward += (double)r;
  if (d) {
    s.done += 1.0;
    s.ret += (double)er;
    s.len += (double)el;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's sums, on thread 0 (fixed order: lanes by shuffle, then the
// warps one after another).
template <int kBlock>
__device__ __forceinline__ Sums block_sum(Sums s) {
  __shared__ double part[4][kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s.reward = warp_sum(s.reward);
  s.done = warp_sum(s.done);
  s.ret = warp_sum(s.ret);
  s.len = warp_sum(s.len);
  if (lane == 0) {
    part[0][warp] = s.reward;
    part[1][warp] = s.done;
    part[2][warp] = s.ret;
    part[3][warp] = s.len;
  }
  __syncthreads();
  Sums out{0.0, 0.0, 0.0, 0.0};
  if (threadIdx.x == 0) {
    for (int w = 0; w < kBlock / 32; ++w) {
      out.reward += part[0][w];
      out.done += part[1][w];
      out.ret += part[2][w];
      out.len += part[3][w];
    }
  }
  return out;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    rollout_epilogue_kernel(const float* __restrict__ reward, const bool* __restrict__ term,
                            const bool* __restrict__ trunc, const float* __restrict__ ep_ret,
                            const float* __restrict__ ep_len, float* __restrict__ ep_ret_out,
                            float* __restrict__ ep_len_out, double* __restrict__ acc, int accumulate, int B) {
  Sums s{0.0, 0.0, 0.0, 0.0};
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  int tail = 0;
  if (kVec) {
    const int nv = B >> 2;
    for (int v = first; v < nv; v += stride) {
      const float4 r = reinterpret_cast<const float4*>(reward)[v];
      const uchar4 t = reinterpret_cast<const uchar4*>(term)[v];
      const uchar4 u = reinterpret_cast<const uchar4*>(trunc)[v];
      const float4 a = reinterpret_cast<const float4*>(ep_ret)[v];
      const float4 l = reinterpret_cast<const float4*>(ep_len)[v];
      float4 ao, lo;
      one_env(r.x, (t.x | u.x) != 0, a.x, l.x, ao.x, lo.x, s);
      one_env(r.y, (t.y | u.y) != 0, a.y, l.y, ao.y, lo.y, s);
      one_env(r.z, (t.z | u.z) != 0, a.z, l.z, ao.z, lo.z, s);
      one_env(r.w, (t.w | u.w) != 0, a.w, l.w, ao.w, lo.w, s);
      reinterpret_cast<float4*>(ep_ret_out)[v] = ao;
      reinterpret_cast<float4*>(ep_len_out)[v] = lo;
    }
    tail = nv << 2;
  }
  for (int i = tail + first; i < B; i += stride)
    one_env(reward[i], term[i] || trunc[i], ep_ret[i], ep_len[i], ep_ret_out[i], ep_len_out[i], s);
  const Sums b = block_sum<kThreads>(s);
  if (threadIdx.x == 0) {
    const double v[4] = {b.reward, b.done, b.ret, b.len};
    for (int k = 0; k < 4; ++k) {
      double* slot = acc + k * kMaxSlots + blockIdx.x;
      *slot = accumulate ? *slot + v[k] : v[k];
    }
  }
}

__global__ void __launch_bounds__(kFinishThreads)
    rollout_epilogue_finish_kernel(const double* __restrict__ acc, int G, float* __restrict__ sums_out,
                                   long long* __restrict__ episodes_out) {
  Sums s{0.0, 0.0, 0.0, 0.0};
  for (int g = threadIdx.x; g < G; g += kFinishThreads) {
    s.reward += acc[g];
    s.done += acc[kMaxSlots + g];
    s.ret += acc[2 * kMaxSlots + g];
    s.len += acc[3 * kMaxSlots + g];
  }
  const Sums b = block_sum<kFinishThreads>(s);
  if (threadIdx.x == 0) {
    sums_out[0] = (float)b.reward;
    sums_out[1] = (float)b.ret;
    sums_out[2] = (float)b.len;
    *episodes_out = (long long)b.done;  // exact: a double holds whole numbers to 2^53
  }
}

bool aligned(const void* p, uintptr_t n) { return ((uintptr_t)p % n) == 0; }

}  // namespace

extern "C" {

// One step's bookkeeping for B envs (see the top of this file); acc is the
// (4, 1024) float64 scratch, its first G slots of each row stored into
// where accumulate is 0 and added to otherwise.  Returns a cudaError_t.
int rollout_epilogue(const float* reward, const bool* term, const bool* trunc, const float* ep_ret,
                     const float* ep_len, float* ep_ret_out, float* ep_len_out, double* acc, int accumulate,
                     int B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = slots(B);
  const bool vec = aligned(reward, 16) && aligned(ep_ret, 16) && aligned(ep_len, 16) && aligned(ep_ret_out, 16) &&
                   aligned(ep_len_out, 16) && aligned(term, 4) && aligned(trunc, 4);
  if (vec)
    rollout_epilogue_kernel<true><<<G, kThreads, 0, s>>>(reward, term, trunc, ep_ret, ep_len, ep_ret_out,
                                                         ep_len_out, acc, accumulate, B);
  else
    rollout_epilogue_kernel<false><<<G, kThreads, 0, s>>>(reward, term, trunc, ep_ret, ep_len, ep_ret_out,
                                                          ep_len_out, acc, accumulate, B);
  return (int)cudaGetLastError();
}

// The call's metrics from the scratch of a batch of B envs: sums_out =
// [total reward, episode return sum, episode length sum] (float32),
// episodes_out the episode count (int64).  Returns a cudaError_t.
int rollout_epilogue_finish(const double* acc, int B, float* sums_out, long long* episodes_out, void* stream) {
  rollout_epilogue_finish_kernel<<<1, kFinishThreads, 0, (cudaStream_t)stream>>>(acc, slots(B), sums_out,
                                                                                 episodes_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
