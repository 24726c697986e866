// The capped one-thread VSS step (vss_thread.cu has the design notes):
// vss_thread_kernel_bounded<N, RNG, kCappedMinBlocks>, 128 registers and 16
// warps per SM, for 7-10 robots, in a file of its own so that it builds
// beside vss_thread.cu.
#include "vss_thread.cuh"

extern "C" {

// The one-thread kernel with its registers capped for kCappedMinBlocks
// blocks per SM, for 7-10 robots (cudaErrorInvalidValue at other team
// sizes): the same arguments and outputs, bit for bit.
int vss_full_step_one_thread_capped(int n_blue, int n_yellow, int emit_final, int rng_kernel, int exact_trig,
                                    const VssParams* p, const float* st, const float* act, const float* ou,
                                    const float* sp, const float* th, const long long* key, float* st_out,
                                    float* obs_out, float* aux_out, int env_base, int B, void* stream) {
  if (n_blue < 1 || n_blue > kMaxBlue || n_yellow < 0 || n_yellow > kMaxYellow) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define VSS_THREAD(N)                                                                                            \
  case N:                                                                                                        \
    return (int)launch_thread<N, true>(n_blue, emit_final, rng_kernel, exact_trig, *p, st, act, ou, sp, \
                                                   th, key, (uint32_t)env_base, st_out, obs_out, aux_out, B, s)
  switch (n_blue + n_yellow) {
    VSS_THREAD(7);
    VSS_THREAD(8);
    VSS_THREAD(9);
    VSS_THREAD(10);
  }
#undef VSS_THREAD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
