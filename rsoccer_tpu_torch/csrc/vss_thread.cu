// Fused VSS-v0 env step on one thread per env: vss_thread_kernel, the
// second design of vss_full.cu's step (the TPU kernel it replaces, the
// per-env work, the layout and the numerics are there), and its
// register-bounded instantiations.
//
// The one-thread kernel (vss_thread_kernel<N, RNG>, every team size; 3v3
// and 5v5 above their group crossovers): one env per thread, 64 threads per
// block, each row read or written by consecutive threads at consecutive
// addresses (coalesced without staging); loops over the compile-time robot
// count fully unrolled, the blue count, the obs variant and the trig policy
// run-time arguments.  It runs the group kernel's operations on the same
// values (vss_thread_substep), so at 3v3 and 5v5 both give the same bits.
// What bounds it (PERF.md, section 6): a substep is ~3100 warp instructions
// (3v3), issued at ~3.1 per cycle of 4 once the SM holds 16 warps, so the
// substeps are issue-bound; what is left is the time the load and store
// phases of all resident warps stand beside them, and the registers set
// how many warps there are to overlap.  So only what the substeps read stays
// in registers through them (robots, ball, drive targets, carried trig):
// the OU rows are stored before them (a done env zeroes them after), the
// reset headings are drawn only in done envs from their own Philox blocks
// (counter-based: the words the OU draw would have given), and the nine
// cold rows (steps, ball potential, shaping) go to a [value][thread]
// shared array by 4-byte asynchronous copies (cp.async, any batch and
// alignment) that hold no register and land while the thread steps; cos
// and sin of one angle come from one sincosf (bit for bit cosf and sinf on
// every f32, checked on the card).  3v3 then builds in 128 registers (16
// warps per SM, from 165 and 12; kThreadMinBlocks holds N = 6 and 8 in the
// register counts the compiler exceeds in one RNG variant each when left
// free).  At 7-10 robots the kernel still takes 168-255 registers (8-12
// warps); the same step under __launch_bounds__(64, 8)
// (vss_thread_kernel_bounded<N, RNG, kCappedMinBlocks>: 128 registers, 16
// warps, with spills) runs faster where the batch needs more than one wave
// of the uncapped kernel and slower below, so the wrapper launches it (the
// _capped entry) above ops/vss_full.THREAD_UNCAPPED_MAX_ENVS.  One
// cp.async.bulk per row segment on an mbarrier (16-byte aligned batches)
// measured no faster than the 4-byte copies and was not kept.
#include "vss_thread.cuh"

extern "C" {

// The same step on the one-thread kernel: the same arguments and outputs,
// every team size from 1v0 to 5v5 (cudaErrorInvalidValue outside).
int vss_full_step_one_thread(int n_blue, int n_yellow, int emit_final, int rng_kernel, int exact_trig,
                             const VssParams* p, const float* st, const float* act, const float* ou,
                             const float* sp, const float* th, const long long* key, float* st_out, float* obs_out,
                             float* aux_out, int env_base, int B, void* stream) {
  if (n_blue < 1 || n_blue > kMaxBlue || n_yellow < 0 || n_yellow > kMaxYellow) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define VSS_THREAD(N)                                                                                    \
  case N:                                                                                                \
    return (int)launch_thread<N, false>(n_blue, emit_final, rng_kernel, exact_trig, *p, st, act, ou, sp, th, key, \
                                    (uint32_t)env_base, st_out, obs_out, aux_out, B, s)
  switch (n_blue + n_yellow) {
    VSS_THREAD(1);
    VSS_THREAD(2);
    VSS_THREAD(3);
    VSS_THREAD(4);
    VSS_THREAD(5);
    VSS_THREAD(6);
    VSS_THREAD(7);
    VSS_THREAD(8);
    VSS_THREAD(9);
    VSS_THREAD(10);
  }
#undef VSS_THREAD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
