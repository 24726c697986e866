// VSS physics only: one control step (5 substeps) of the differential-drive
// world, one env per thread.
//
// Replaces the TPU kernel rsoccer_tpu/ops/pallas_vss.py:37
// (make_pallas_vss_physics, pallas_call :194), which BatchedEnv's
// pallas_physics path runs between the task's pre- and post-physics.  Per
// substep, as that kernel and physics/vss.py: wheel targets tracked under
// acceleration clamps with lateral slip decay -> heading wrap (exact
// sinf/cosf) -> integrate -> all-pairs robot contacts, every pair reading
// the pre-pass values and each robot's corrections summed in robot order
// (the dense N x N sums) -> robot wall clamp -> ball friction (divided by
// the speed), vertical axis, integrate -> ball-robot contacts -> ball
// walls with goal pockets.
//
// Layout: robots (6, N, B) rows [x, y, theta, v_x, v_y, v_theta], ball
// (6, B) [x, y, z, v_x, v_y, v_z], wheel commands (2, N, B) [left, right],
// all flat row-major f32 read as p[row * B + b]: each row load coalesced.
//
// What bounds it: at B = 8192 it moves 3.1 MB (96 rows: robots and ball in
// and out, commands in), 0.94 us of HBM time, while each thread runs 5 substeps x
// (6 robots + 15 pairs + 6 ball contacts) of dependent scalar work with
// 12 sinf/cosf per substep: latency bound, as the fused steps are.  The
// env stays in registers (loops over the compile-time N), each input row
// is read once and each output row written once.
//
// Numerics: --fmad=false and no fast math (ops/_build.py), and sqrtf with
// true division where physics/vss.py divides, so the kernel rounds as its
// plain version does.
#include <cuda_runtime.h>

#define VSS_PHYS_PARAMS(X)                                                                            \
  X(dts) X(lat_keep) X(a_lin) X(a_ang) X(max_wheel) X(wheel_r) X(two_half_axle) X(half_len) X(half_wid) \
  X(goal_half) X(hl_goal) X(r_ball) X(two_r) X(r_sum) X(xl) X(yl) X(ground_z) X(fric) X(gravity_dts)   \
  X(neg_rest_ground) X(bounce_min_v) X(rbt_height) X(pair_gain) X(ball_gain) X(neg_rest_wall) X(two_pi) X(pi)

struct VssPhysParams {
#define VSS_PHYS_FIELD(n) float n;
  VSS_PHYS_PARAMS(VSS_PHYS_FIELD)
#undef VSS_PHYS_FIELD
};

namespace {

constexpr int kThreads = 64;
constexpr int kSubsteps = 5;  // PhysicsConfig.n_substeps (the wrapper checks)

__device__ __forceinline__ float clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

// torch.sign: 0 at 0
__device__ __forceinline__ float signf(float v) { return (float)(v > 0.0f) - (float)(v < 0.0f); }

// torch.remainder(t + pi, 2 pi) - pi: fmodf takes the dividend's sign, so a
// negative remainder moves up by one period (floor-mod)
__device__ __forceinline__ float wrap_angle(float t, const VssPhysParams& p) {
  float r = fmodf(t + p.pi, p.two_pi);
  if (r != 0.0f && r < 0.0f) r += p.two_pi;
  return r - p.pi;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    vss_physics_kernel(const VssPhysParams p, const float* __restrict__ rb_in, const float* __restrict__ ball_in,
                       const float* __restrict__ cmd, float* __restrict__ rb_out, float* __restrict__ ball_out,
                       int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
#define LD(ptr, row) ((ptr)[(size_t)(row) * (size_t)B + b])

  float x[N], y[N], th[N], vx[N], vy[N], w[N], v_tgt[N], w_tgt[N], c[N], s[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    x[r] = LD(rb_in, r);
    y[r] = LD(rb_in, N + r);
    th[r] = LD(rb_in, 2 * N + r);
    vx[r] = LD(rb_in, 3 * N + r);
    vy[r] = LD(rb_in, 4 * N + r);
    w[r] = LD(rb_in, 5 * N + r);
    const float wl = clampf(LD(cmd, r), -p.max_wheel, p.max_wheel);
    const float wr = clampf(LD(cmd, N + r), -p.max_wheel, p.max_wheel);
    v_tgt[r] = p.wheel_r * (wl + wr) / 2.0f;
    w_tgt[r] = p.wheel_r * (wr - wl) / p.two_half_axle;
    c[r] = cosf(th[r]);
    s[r] = sinf(th[r]);
  }
  float bx = LD(ball_in, 0), by = LD(ball_in, 1), bz = LD(ball_in, 2);
  float bvx = LD(ball_in, 3), bvy = LD(ball_in, 4), bvz = LD(ball_in, 5);

#pragma unroll 1  // kept rolled: the unrolled body would be 5x the code
  for (int sub = 0; sub < kSubsteps; ++sub) {
    // ---- drive (c, s: the heading trig, carried from the last substep)
#pragma unroll
    for (int r = 0; r < N; ++r) {
      float u = vx[r] * c[r] + vy[r] * s[r];
      float sl = -vx[r] * s[r] + vy[r] * c[r];
      u = u + clampf(v_tgt[r] - u, -p.a_lin, p.a_lin);
      sl = sl * p.lat_keep;
      w[r] = w[r] + clampf(w_tgt[r] - w[r], -p.a_ang, p.a_ang);
      th[r] = wrap_angle(th[r] + w[r] * p.dts, p);
      c[r] = cosf(th[r]);
      s[r] = sinf(th[r]);
      vx[r] = u * c[r] - sl * s[r];
      vy[r] = u * s[r] + sl * c[r];
      x[r] = x[r] + vx[r] * p.dts;
      y[r] = y[r] + vy[r] * p.dts;
    }

    // ---- robot-robot contacts.  Pair (i, j) gives i the terms of the
    // dense sum's [i, j] entry and j their exact negation ([j, i]); pairs
    // run in (i, j) order, so each robot sums its terms in robot order.
    {
      float dpx[N], dpy[N], dvx[N], dvy[N];
#pragma unroll
      for (int r = 0; r < N; ++r) dpx[r] = dpy[r] = dvx[r] = dvy[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = i + 1; j < N; ++j) {
          const float dx = x[i] - x[j];
          const float dy = y[i] - y[j];
          const float d = sqrtf(fmaxf(dx * dx + dy * dy, 1e-16f));
          const float overlap = p.two_r - d;
          const bool col = overlap > 0.0f;
          const float nx = dx / fmaxf(d, 1e-8f);
          const float ny = dy / fmaxf(d, 1e-8f);
          const float push = col ? 0.5f * overlap : 0.0f;
          const float vn = (vx[i] - vx[j]) * nx + (vy[i] - vy[j]) * ny;
          const float imp = (col && vn < 0.0f) ? p.pair_gain * vn : 0.0f;
          dpx[i] = dpx[i] + push * nx;
          dpy[i] = dpy[i] + push * ny;
          dvx[i] = dvx[i] + imp * nx;
          dvy[i] = dvy[i] + imp * ny;
          dpx[j] = dpx[j] - push * nx;
          dpy[j] = dpy[j] - push * ny;
          dvx[j] = dvx[j] - imp * nx;
          dvy[j] = dvy[j] - imp * ny;
        }
      }
#pragma unroll
      for (int r = 0; r < N; ++r) {
        x[r] = x[r] + dpx[r];
        y[r] = y[r] + dpy[r];
        vx[r] = vx[r] + dvx[r];
        vy[r] = vy[r] + dvy[r];
      }
    }

    // ---- robots clamp dead against the walls
#pragma unroll
    for (int r = 0; r < N; ++r) {
      vx[r] = (fabsf(x[r]) > p.xl && vx[r] * signf(x[r]) > 0.0f) ? 0.0f : vx[r];
      vy[r] = (fabsf(y[r]) > p.yl && vy[r] * signf(y[r]) > 0.0f) ? 0.0f : vy[r];
      x[r] = clampf(x[r], -p.xl, p.xl);
      y[r] = clampf(y[r], -p.yl, p.yl);
    }

    // ---- ball: rolling friction while grounded, vertical axis, integrate
    const bool on_ground = bz <= p.ground_z;
    const float speed = sqrtf(bvx * bvx + bvy * bvy + 1e-16f);
    const float scale = fmaxf(1.0f - p.fric / speed, 0.0f);
    if (on_ground) {
      bvx = bvx * scale;
      bvy = bvy * scale;
    }
    bvz = bvz - p.gravity_dts;
    bz = bz + bvz * p.dts;
    const bool hit_floor = bz < p.r_ball;
    if (hit_floor && bvz < 0.0f) bvz = p.neg_rest_ground * bvz;
    if (hit_floor && bvz < p.bounce_min_v) bvz = 0.0f;
    if (hit_floor) bz = p.r_ball;
    bx = bx + bvx * p.dts;
    by = by + bvy * p.dts;

    // ---- ball vs robots (a ball above the robots' top plate flies over)
    const bool below_top = (bz - p.r_ball) < p.rbt_height;
    float push_x = 0.0f, push_y = 0.0f, imp_x = 0.0f, imp_y = 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float dx = bx - x[r];
      const float dy = by - y[r];
      const float d = sqrtf(fmaxf(dx * dx + dy * dy, 1e-16f));
      const float overlap = p.r_sum - d;
      const bool col = overlap > 0.0f && below_top;
      const float nx = dx / fmaxf(d, 1e-8f);
      const float ny = dy / fmaxf(d, 1e-8f);
      push_x = push_x + (col ? overlap : 0.0f) * nx;
      push_y = push_y + (col ? overlap : 0.0f) * ny;
      const float vn = (bvx - vx[r]) * nx + (bvy - vy[r]) * ny;
      const float j = (col && vn < 0.0f) ? p.ball_gain * vn : 0.0f;
      imp_x = imp_x + j * nx;
      imp_y = imp_y + j * ny;
    }
    bx = bx + push_x;
    by = by + push_y;
    bvx = bvx + imp_x;
    bvy = bvy + imp_y;

    // ---- ball walls, with goal pockets behind the end lines
    const bool in_mouth = fabsf(by) < p.goal_half;
    const float x_wall = (in_mouth ? p.hl_goal : p.half_len) - p.r_ball;
    const float sx = signf(bx);
    const bool hit_x = fabsf(bx) - x_wall > 0.0f;
    if (hit_x) bx = sx * x_wall;
    if (hit_x && bvx * sx > 0.0f) bvx = p.neg_rest_wall * bvx;
    const bool in_pocket = fabsf(bx) > p.half_len;
    const float y_wall = (in_pocket ? p.goal_half : p.half_wid) - p.r_ball;
    const float sy = signf(by);
    const bool hit_y = fabsf(by) - y_wall > 0.0f;
    if (hit_y) by = sy * y_wall;
    if (hit_y && bvy * sy > 0.0f) bvy = p.neg_rest_wall * bvy;
  }

#pragma unroll
  for (int r = 0; r < N; ++r) {
    LD(rb_out, r) = x[r];
    LD(rb_out, N + r) = y[r];
    LD(rb_out, 2 * N + r) = th[r];
    LD(rb_out, 3 * N + r) = vx[r];
    LD(rb_out, 4 * N + r) = vy[r];
    LD(rb_out, 5 * N + r) = w[r];
  }
  const float ball[6] = {bx, by, bz, bvx, bvy, bvz};
#pragma unroll
  for (int k = 0; k < 6; ++k) LD(ball_out, k) = ball[k];
#undef LD
}

}  // namespace

extern "C" {

// field names of VssPhysParams in order, comma-terminated; the Python side
// checks its ctypes mirror against this string before the first launch
const char* vss_physics_params_fields() {
#define VSS_PHYS_NAME(n) #n ","
  return VSS_PHYS_PARAMS(VSS_PHYS_NAME);
#undef VSS_PHYS_NAME
}

// One physics step of B VSS worlds.  n_robots compiled: 6 (VSS-v0's 3v3).
// Returns a cudaError_t (cudaErrorInvalidValue for another n_robots).
int vss_physics_step(const VssPhysParams* p, const float* robots, const float* ball, const float* cmd,
                     float* robots_out, float* ball_out, int n_robots, int B, void* stream) {
  if (n_robots != 6) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  vss_physics_kernel<6><<<grid, block, 0, (cudaStream_t)stream>>>(*p, robots, ball, cmd, robots_out, ball_out, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
