// One VSS world substep run cooperatively by a group of G lanes per env
// (lane_group.cuh): the substep of the fused VSS step (vss_full.cu, K1) and
// of the physics-only kernel (vss_physics.cu, K2); G = 8 at 3v3 / N = 6,
// G = 16 at 5v5 / N = 10.
//
// Layout (VssLayout<N, G>): the env of a group runs on G consecutive lanes
// of a warp (32 / G envs per warp).  Lane k < N owns robot k (lanes k >= N
// carry a copy of robot 0 that nothing reads) and evaluates pairs k,
// k + G, ... (kPairsPerLane of them: 2 for 15 pairs on 8 lanes, 3 for 45
// on 16) of the N(N-1)/2 robot pairs (lexicographic over i < j); the slots
// past the last pair are padding pairs that write two spare slots.  Every
// lane carries the ball and updates it with the same operations on the same
// values, so the ball needs no broadcast.  The group exchanges values
// through its kSlots float4 slots in shared memory, between __syncwarp()s
// (48 at N = 6, G = 8: 768 bytes; 124 at N = 10, G = 16: 1,984 bytes,
// 31,744 for a block's 16 envs).  A substep:
//   1. every lane drives, turns and integrates its robot and posts the
//      robot's (x, y, v_x, v_y); every lane applies the ball's rolling
//      friction, vertical axis and integration (before its contacts the
//      ball does not depend on the robots);
//   2. each pair's terms are computed once, from the posted pre-pass values
//      and from the lower robot's side, and posted into the two robots'
//      partner slots: as they are for robot i, negated for robot j;
//   3. robot k adds its partner slots 0..N-2 (partners 0..N-1 without
//      itself) in order, then clamps against the walls;
//   4. robot k posts its ball-contact term; every lane sums the N terms in
//      robot order and applies the ball walls with goal pockets.
//
// Why the results are the one-thread-per-env kernels' to the bit, at any
// G: each pair's terms are computed as there, once and from the lower
// robot's side, whichever lane evaluates the pair; robot k's corrections
// are added in the order of the pair-list pass (pair_collide.cuh) and of
// the dense N x N row sums, which both visit robot k's partners 0..N-1 in
// order; adding a negated term rounds as subtracting it.  Neither the lane
// that evaluates a pair nor the width G enters any value.  (The dense sums
// compute robot k's row from its own side, x_k - x_q; IEEE subtraction and
// division are sign-symmetric, so those terms are the exact negations:
// tests/test_torch_vss_pair_order.py.)
//
// The one-thread kernels (K1's vss_thread_kernel, K2's
// vss_physics_thread_kernel, and their register-capped variants) step an
// env on one thread with vss_thread_substep: the same operations on the
// same values, each pair once from the lower robot's side, each robot's
// terms in partner order, so at 3v3 and 5v5 the two designs agree to the
// bit.  Their substeps are issue-bound (~3.1 warp instructions per cycle
// of 4 at 16 warps per SM, PERF.md, section 6): the kernels keep the registers
// they hold through the substeps to the substeps' own values, and take
// cos and sin of a heading from one sincosf (ExactTrigPaired,
// RsqrtPickedTurn); keeping the drive targets and the pre-pass values in
// shared memory instead cost more than the registers it freed.
//
// Numerics are a policy:
//   TaylorRsqrt (K1): the TPU kernel's reduced-range Taylor rotation of a
//     carried (cos, sin) and rsqrt normals; pair terms added straight into
//     x, y, v_x, v_y (pair_collide.cuh's form).
//   ExactRsqrt (K1 beyond the Taylor bound): as TaylorRsqrt, with exact
//     cosf/sinf of the wrapped heading each substep (the TPU kernel's
//     `else` branch, pallas_vss_full.py:307-309).
//   ExactTrig (K2): physics/vss.py's sinf/cosf of the wrapped heading,
//     sqrtf and true division; pair terms summed, then added (the dense
//     row sums' form).
// All build with --fmad=false and no fast math (ops/_build.py).
#pragma once
#include "lane_group.cuh"

__device__ __forceinline__ float clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

// torch.sign / jnp.sign: 0 at 0
__device__ __forceinline__ float signf(float v) { return (float)(v > 0.0f) - (float)(v < 0.0f); }

// torch.remainder(t + pi, 2 pi) - pi: fmodf takes the dividend's sign, so a
// negative remainder moves up by one period (floor-mod)
template <class P>
__device__ __forceinline__ float wrap_angle(float t, const P& p) {
  float r = t + p.pi;
  if (!(r >= 0.0f && r < p.two_pi)) {  // in [0, 2 pi) fmodf returns r itself
    r = fmodf(r, p.two_pi);
    if (r != 0.0f && r < 0.0f) r += p.two_pi;
  }
  return r - p.pi;
}

__device__ __forceinline__ float4 neg4(float4 v) { return make_float4(-v.x, -v.y, -v.z, -v.w); }

struct VssRobot {
  float x, y, th, vx, vy, w;
  float c, s;          // cos, sin of th, carried across substeps
  float v_tgt, w_tgt;  // the step's drive targets
};

struct VssBall {
  float x, y, z, vx, vy, vz;
};

template <int N, int G>
struct VssLayout {
  static constexpr int kPairs = N * (N - 1) / 2;
  static constexpr int kPairsPerLane = (kPairs + G - 1) / G;
  static_assert(N <= G && kPairsPerLane <= 3, "one robot and at most three pairs per lane");
  static constexpr int kDescs = kPairsPerLane * G;  // pairs, then padding pairs
  // a group's float4 slots in shared memory: robot states (G), partner
  // terms (robot q's partner t at q (N - 1) + t, then 2 slots that the
  // padding pairs write), contact terms (G)
  static constexpr int kXs = 0, kPt = G, kCt = kPt + N * (N - 1) + 2, kSlots = kCt + G;
};

// The VSS group kernels' blocks per SM (launch bounds): 2 on 8 lanes (K1
// at 3v3: 63-90 registers, K2 at N = 6: 56, no spills), 4 on 16 (K1 at
// 5v5, K2 at N = 10): 64 registers, so the 512 blocks of 8192 envs run in
// one wave on 132 SMs.  At 5v5 that costs K1 44-84 bytes of spills per
// thread and K2 4; measured in turns, both run faster than at 2 blocks
// per SM (80-86 and 65 registers, no spills), and keeping K1's idle
// values in shared memory cut its spills to 8-20 bytes for no gain
// (PERF.md, section 6).
template <int G>
constexpr int kVssMinBlocks = G == 16 ? 4 : 2;

// Pair p's (i, j, i's slot, j's slot), p < VssLayout::kDescs; a padding
// pair reads robots 0, 1 and writes the two spare slots.
template <int N>
__device__ __forceinline__ int4 pair_desc(int p) {
  int4 d = make_int4(0, 1, N * (N - 1), N * (N - 1) + 1);
#pragma unroll
  for (int i = 0, q = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j, ++q)
      if (q == p) d = make_int4(i, j, i * (N - 1) + (j - 1), j * (N - 1) + i);
  return d;
}

struct TaylorRsqrt {
  static constexpr bool kSumThenAdd = false;  // pair terms straight into x (pair_collide.cuh)

  // |w * dts| <= 0.35 (the wrapper checks): the degree-7/6 Taylor terms are
  // exact far below f32 resolution, and no transcendental runs per substep
  template <class P>
  static __device__ __forceinline__ void turn(const P& p, VssRobot& r) {
    const float dth = r.w * p.dts;
    r.th = wrap_angle(r.th + dth, p);
    const float dd = dth * dth;
    const float sin_d = dth * (1.0f + dd * ((float)(-1.0 / 6.0) + dd * ((float)(1.0 / 120.0) - dd / 5040.0f)));
    const float cos_d = 1.0f + dd * (-0.5f + dd * ((float)(1.0 / 24.0) - dd / 720.0f));
    const float cos_n = r.c * cos_d - r.s * sin_d;
    r.s = r.s * cos_d + r.c * sin_d;
    r.c = cos_n;
  }

  template <class P>
  static __device__ __forceinline__ float friction_scale(const P& p, float bvx, float bvy) {
    const float inv_speed = rsqrtf(bvx * bvx + bvy * bvy + 1e-16f);
    return fmaxf(0.0f, 1.0f - p.fric * inv_speed);
  }

  // overlap with the ball and the unit normal robot -> ball
  template <class P>
  static __device__ __forceinline__ void contact(const P& p, float dx, float dy, float& overlap, float& nx,
                                                 float& ny) {
    const float d2 = fmaxf(dx * dx + dy * dy, 1e-16f);
    const float inv_d = rsqrtf(d2);
    overlap = p.r_sum - d2 * inv_d;
    nx = dx * inv_d;
    ny = dy * inv_d;
  }

  // the terms robot i adds for pair (i, j): position x, y, velocity x, y
  template <class P>
  static __device__ __forceinline__ float4 pair_term(const P& p, float4 a, float4 b) {
    const float dx = a.x - b.x;
    const float dy = a.y - b.y;
    const float d2 = fmaxf(dx * dx + dy * dy, 1e-16f);
    const float inv_d = rsqrtf(d2);
    const float overlap = p.two_r - d2 * inv_d;
    const bool col = overlap > 0.0f;
    const float f = (col ? 0.5f * overlap : 0.0f) * inv_d;
    const float rvx = a.z - b.z, rvy = a.w - b.w;
    const float vn = rvx * dx + rvy * dy;  // (v_rel . n) * d
    const float g = ((col && vn < 0.0f) ? p.pair_gain * vn : 0.0f) * (inv_d * inv_d);
    return make_float4(f * dx, f * dy, g * dx, g * dy);
  }
};

struct ExactTrig {
  static constexpr bool kSumThenAdd = true;  // pair terms summed, then added (the dense row sums)

  template <class P>
  static __device__ __forceinline__ void turn(const P& p, VssRobot& r) {
    r.th = wrap_angle(r.th + r.w * p.dts, p);
    r.c = cosf(r.th);
    r.s = sinf(r.th);
  }

  template <class P>
  static __device__ __forceinline__ float friction_scale(const P& p, float bvx, float bvy) {
    const float speed = sqrtf(bvx * bvx + bvy * bvy + 1e-16f);
    return fmaxf(1.0f - p.fric / speed, 0.0f);
  }

  template <class P>
  static __device__ __forceinline__ void contact(const P& p, float dx, float dy, float& overlap, float& nx,
                                                 float& ny) {
    const float d = sqrtf(fmaxf(dx * dx + dy * dy, 1e-16f));
    overlap = p.r_sum - d;
    nx = dx / fmaxf(d, 1e-8f);
    ny = dy / fmaxf(d, 1e-8f);
  }

  template <class P>
  static __device__ __forceinline__ float4 pair_term(const P& p, float4 a, float4 b) {
    const float dx = a.x - b.x;
    const float dy = a.y - b.y;
    const float d = sqrtf(fmaxf(dx * dx + dy * dy, 1e-16f));
    const float overlap = p.two_r - d;
    const bool col = overlap > 0.0f;
    const float nx = dx / fmaxf(d, 1e-8f);
    const float ny = dy / fmaxf(d, 1e-8f);
    const float push = col ? 0.5f * overlap : 0.0f;
    const float vn = (a.z - b.z) * nx + (a.w - b.w) * ny;
    const float imp = (col && vn < 0.0f) ? p.pair_gain * vn : 0.0f;
    return make_float4(push * nx, push * ny, imp * nx, imp * ny);
  }
};

struct ExactRsqrt : TaylorRsqrt {
  template <class P>
  static __device__ __forceinline__ void turn(const P& p, VssRobot& r) {
    ExactTrig::turn(p, r);
  }
};

// cos and sin of one angle from one sincosf: bit for bit cosf and sinf
// (every f32 checked on the card under the port's flags, PERF.md)
__device__ __forceinline__ void cos_sin(float t, float& c, float& s) { sincosf(t, &s, &c); }

// ExactTrig with the turn's cos and sin from one sincosf (K2's one-thread
// kernel)
struct ExactTrigPaired : ExactTrig {
  template <class P>
  static __device__ __forceinline__ void turn(const P& p, VssRobot& r) {
    r.th = wrap_angle(r.th + r.w * p.dts, p);
    cos_sin(r.th, r.c, r.s);
  }
};

// K1's numerics with the turn picked per launch (the one-thread kernel,
// which would otherwise be built twice for every robot count): a
// warp-uniform branch between the two turns, the exact one's cos and sin
// from one sincosf
struct RsqrtPickedTurn : TaylorRsqrt {
  bool exact;

  template <class P>
  __device__ __forceinline__ void turn(const P& p, VssRobot& r) const {
    if (exact) ExactTrigPaired::turn(p, r);
    else TaylorRsqrt::turn(p, r);
  }
};

// ---- pieces of a substep shared by both designs

// drive, turn and integrate a robot (c, s: the heading trig carried from
// the last substep)
template <class Pol, class P>
__device__ __forceinline__ void vss_drive(const P& p, const Pol& pol, VssRobot& r) {
  float u = r.vx * r.c + r.vy * r.s;
  float sl = -r.vx * r.s + r.vy * r.c;
  u = u + clampf(r.v_tgt - u, -p.a_lin, p.a_lin);
  sl = sl * p.lat_keep;
  r.w = r.w + clampf(r.w_tgt - r.w, -p.a_ang, p.a_ang);
  pol.turn(p, r);
  r.vx = u * r.c - sl * r.s;
  r.vy = u * r.s + sl * r.c;
  r.x = r.x + r.vx * p.dts;
  r.y = r.y + r.vy * p.dts;
}

// the ball before its contacts: rolling friction while grounded, vertical
// axis, integrate (none of it depends on the robots)
template <class Pol, class P>
__device__ __forceinline__ void vss_ball_flight(const P& p, VssBall& b) {
  const bool on_ground = b.z <= p.ground_z;
  const float scale = Pol::friction_scale(p, b.vx, b.vy);
  if (on_ground) {
    b.vx = b.vx * scale;
    b.vy = b.vy * scale;
  }
  b.vz = b.vz - p.gravity_dts;
  b.z = b.z + b.vz * p.dts;
  const bool hit_floor = b.z < p.r_ball;
  if (hit_floor && b.vz < 0.0f) b.vz = p.neg_rest_ground * b.vz;
  if (hit_floor && b.vz < p.bounce_min_v) b.vz = 0.0f;
  if (hit_floor) b.z = p.r_ball;
  b.x = b.x + b.vx * p.dts;
  b.y = b.y + b.vy * p.dts;
}

// robots clamp dead against the walls
template <class P>
__device__ __forceinline__ void vss_robot_walls(const P& p, VssRobot& r) {
  r.vx = (fabsf(r.x) > p.xl && r.vx * signf(r.x) > 0.0f) ? 0.0f : r.vx;
  r.vy = (fabsf(r.y) > p.yl && r.vy * signf(r.y) > 0.0f) ? 0.0f : r.vy;
  r.x = clampf(r.x, -p.xl, p.xl);
  r.y = clampf(r.y, -p.yl, p.yl);
}

// robot r's ball-contact term: push x, y, impulse x, y (a ball above the
// robots' top plate flies over)
template <class Pol, class P>
__device__ __forceinline__ float4 vss_ball_contact(const P& p, const VssBall& b, const VssRobot& r,
                                                   bool below_top) {
  float overlap, nx, ny;
  Pol::contact(p, b.x - r.x, b.y - r.y, overlap, nx, ny);
  const bool col = overlap > 0.0f && below_top;
  const float vn = (b.vx - r.vx) * nx + (b.vy - r.vy) * ny;
  const float jn = (col && vn < 0.0f) ? p.ball_gain * vn : 0.0f;
  return make_float4((col ? overlap : 0.0f) * nx, (col ? overlap : 0.0f) * ny, jn * nx, jn * ny);
}

// ball walls, with goal pockets behind the end lines
template <class P>
__device__ __forceinline__ void vss_ball_walls(const P& p, VssBall& b) {
  const bool in_mouth = fabsf(b.y) < p.goal_half;
  const float x_wall = (in_mouth ? p.hl_goal : p.half_len) - p.r_ball;
  const float sx = signf(b.x);
  const bool hit_x = fabsf(b.x) > x_wall;
  if (hit_x) b.x = sx * x_wall;
  if (hit_x && b.vx * sx > 0.0f) b.vx = p.neg_rest_wall * b.vx;
  const bool in_pocket = fabsf(b.x) > p.half_len;
  const float y_wall = (in_pocket ? p.goal_half : p.half_wid) - p.r_ball;
  const float sy = signf(b.y);
  const bool hit_y = fabsf(b.y) > y_wall;
  if (hit_y) b.y = sy * y_wall;
  if (hit_y && b.vy * sy > 0.0f) b.vy = p.neg_rest_wall * b.vy;
}

// One substep of the env on this lane's group of G lanes: k is the lane in
// the group, grp the group's VssLayout<N, G>::kSlots slots, desc the block's
// pair table (pair_desc, VssLayout<N, G>::kDescs int4s).  Called by every
// lane of the warp (it synchronises the warp).
template <class Pol, int N, int G, class P>
__device__ __forceinline__ void vss_substep(const P& p, int k, float4* grp, const int4* desc, VssRobot& r,
                                            VssBall& b) {
  using L = VssLayout<N, G>;
  float4* xs = grp + L::kXs;
  float4* pt = grp + L::kPt;
  float4* ct = grp + L::kCt;

  // ---- 1. drive; the ball's flight
  vss_drive(p, Pol{}, r);
  xs[k] = make_float4(r.x, r.y, r.vx, r.vy);
  vss_ball_flight<Pol>(p, b);
  __syncwarp();

  // ---- 2. this lane's pairs, each once, from the pre-pass values
#pragma unroll
  for (int s = 0; s < L::kPairsPerLane; ++s) {
    const int4 d = desc[s * G + k];
    const float4 t = Pol::pair_term(p, xs[d.x], xs[d.y]);
    pt[d.z] = t;
    pt[d.w] = neg4(t);
  }
  __syncwarp();

  // ---- 3. robot k's partner terms in partner order; the walls
  {
    const float4* terms = pt + (k < N ? k : 0) * (N - 1);
    float dpx = 0.0f, dpy = 0.0f, dvx = 0.0f, dvy = 0.0f;
#pragma unroll
    for (int t = 0; t < N - 1; ++t) {
      const float4 v = terms[t];
      if constexpr (Pol::kSumThenAdd) {
        dpx = dpx + v.x;
        dpy = dpy + v.y;
        dvx = dvx + v.z;
        dvy = dvy + v.w;
      } else {
        r.x = r.x + v.x;
        r.y = r.y + v.y;
        r.vx = r.vx + v.z;
        r.vy = r.vy + v.w;
      }
    }
    if constexpr (Pol::kSumThenAdd) {
      r.x = r.x + dpx;
      r.y = r.y + dpy;
      r.vx = r.vx + dvx;
      r.vy = r.vy + dvy;
    }
  }
  vss_robot_walls(p, r);

  // ---- 4. ball vs robots
  ct[k] = vss_ball_contact<Pol>(p, b, r, (b.z - p.r_ball) < p.rbt_height);
  __syncwarp();
  float push_x = 0.0f, push_y = 0.0f, imp_x = 0.0f, imp_y = 0.0f;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float4 c = ct[q];
    push_x = push_x + c.x;
    push_y = push_y + c.y;
    imp_x = imp_x + c.z;
    imp_y = imp_y + c.w;
  }
  b.x = b.x + push_x;
  b.y = b.y + push_y;
  b.vx = b.vx + imp_x;
  b.vy = b.vy + imp_y;

  vss_ball_walls(p, b);
}

// One substep of one env on one thread, the operations of vss_substep: each
// pair once from the lower robot's side on the pre-pass values, robot q's
// terms in partner order 0..N-1 (the pair loop visits them so).
template <int N, class Pol, class P>
__device__ __forceinline__ void vss_thread_substep(const P& p, const Pol& pol, VssRobot (&r)[N], VssBall& b) {
  float4 xs[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    vss_drive(p, pol, r[q]);
    xs[q] = make_float4(r[q].x, r[q].y, r[q].vx, r[q].vy);
  }
  vss_ball_flight<Pol>(p, b);

  float4 d[N];  // the summed terms (kSumThenAdd)
#pragma unroll
  for (int q = 0; q < N; ++q) d[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      const float4 t = Pol::pair_term(p, xs[i], xs[j]);
      if constexpr (Pol::kSumThenAdd) {
        d[i] = make_float4(d[i].x + t.x, d[i].y + t.y, d[i].z + t.z, d[i].w + t.w);
        d[j] = make_float4(d[j].x - t.x, d[j].y - t.y, d[j].z - t.z, d[j].w - t.w);
      } else {
        r[i].x = r[i].x + t.x;
        r[i].y = r[i].y + t.y;
        r[i].vx = r[i].vx + t.z;
        r[i].vy = r[i].vy + t.w;
        r[j].x = r[j].x - t.x;
        r[j].y = r[j].y - t.y;
        r[j].vx = r[j].vx - t.z;
        r[j].vy = r[j].vy - t.w;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if constexpr (Pol::kSumThenAdd) {
      r[q].x = r[q].x + d[q].x;
      r[q].y = r[q].y + d[q].y;
      r[q].vx = r[q].vx + d[q].z;
      r[q].vy = r[q].vy + d[q].w;
    }
    vss_robot_walls(p, r[q]);
  }

  const bool below_top = (b.z - p.r_ball) < p.rbt_height;
  float push_x = 0.0f, push_y = 0.0f, imp_x = 0.0f, imp_y = 0.0f;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float4 c = vss_ball_contact<Pol>(p, b, r[q], below_top);
    push_x = push_x + c.x;
    push_y = push_y + c.y;
    imp_x = imp_x + c.z;
    imp_y = imp_y + c.w;
  }
  b.x = b.x + push_x;
  b.y = b.y + push_y;
  b.vx = b.vx + imp_x;
  b.vy = b.vy + imp_y;
  vss_ball_walls(p, b);
}
