// Pair-list robot-robot collision pass — the __device__ twin of
// rsoccer_tpu_torch/ops/pair_collide.py (and of the JAX package's
// ops/pair_collide.py).  Equal-mass discs: de-penetration split evenly,
// restitution impulse along the center line, over the n(n-1)/2
// upper-triangle pairs in (i, j) order.  Every pair reads the PRE-pass
// values; each body's corrections are added in pair order, which is the
// order of the plain version's scatter.
#pragma once

// 1 / sqrt(x) for a normal x (every caller's x is >= 1e-16): MUFU.RSQ,
// rsqrtf's bits there, without rsqrtf's rescaling of denormal arguments
__device__ __forceinline__ float rsqrt_normal(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return rsqrtf(x);
#endif
}

// two_r = 2 * robot radius; gain = -(1 + restitution) * 0.5
template <int N>
__device__ __forceinline__ void resolve_pair_collisions(float (&x)[N], float (&y)[N], float (&vx)[N],
                                                        float (&vy)[N], float two_r, float gain) {
  float ox[N], oy[N], ovx[N], ovy[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    ox[r] = x[r];
    oy[r] = y[r];
    ovx[r] = vx[r];
    ovy[r] = vy[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      const float dx = ox[i] - ox[j];
      const float dy = oy[i] - oy[j];
      const float d2 = fmaxf(dx * dx + dy * dy, 1e-16f);
      const float inv_d = rsqrt_normal(d2);
      const float overlap = two_r - d2 * inv_d;
      const bool col = overlap > 0.0f;
      const float f = (col ? 0.5f * overlap : 0.0f) * inv_d;
      const float pnx = f * dx, pny = f * dy;
      const float rvx = ovx[i] - ovx[j], rvy = ovy[i] - ovy[j];
      const float vn = rvx * dx + rvy * dy;  // (v_rel . n) * d
      const float g = ((col && vn < 0.0f) ? gain * vn : 0.0f) * (inv_d * inv_d);
      const float gx = g * dx, gy = g * dy;
      x[i] += pnx;
      x[j] -= pnx;
      y[i] += pny;
      y[j] -= pny;
      vx[i] += gx;
      vx[j] -= gx;
      vy[i] += gy;
      vy[j] -= gy;
    }
  }
}
