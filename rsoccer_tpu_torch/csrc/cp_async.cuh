// 4-byte asynchronous copies from global to shared memory (cp.async, any
// address and batch): the one-thread kernels park the state rows that only
// their outcome reads in shared memory this way, so that no register holds
// them through the substeps (vss_thread.cuh, ssl_thread.cu).
#pragma once
#include <cuda_runtime.h>

namespace {

#ifdef __CUDA_ARCH__
__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// one 4-byte asynchronous copy global -> shared (this thread's own slot)
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async4_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

#else  // a host build of the kernels: the same values, copied at once
__device__ __forceinline__ void copy_async4(float* dst, const float* src) { *dst = *src; }
__device__ __forceinline__ void copy_async4_wait() {}
#endif

}  // namespace
