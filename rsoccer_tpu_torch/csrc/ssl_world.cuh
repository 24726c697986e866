// One SSL world substep run cooperatively by a group of kGroup = 8 lanes per
// env (lane_group.cuh): the world step of the fused SSLStaticDefenders-v0
// (K4, N = 7) and SSLDribbling-v0 (K6, N = 5) group kernels in
// ssl_full.cu.  The same physics as ssl_body.cuh's one-thread
// ssl_world_step, under the same contract: only robot 0 drives, turns,
// dribbles and kicks; robots 1..N-1 enter with w = 0 and keep the heading
// trig of the step's start.
//
// Layout: lane k < N owns robot k (lanes N..7 carry a copy of robot 0 that
// nothing reads).  Every lane carries the ball and updates it with the same
// operations on the same values.  The group exchanges values through its
// slots in shared memory, between __syncwarp()s.  A substep:
//   1. every lane drives, turns and integrates its robot (only lane 0 runs
//      sincosf) and posts the robot's (x, y, v_x, v_y); every lane applies
//      the ball's rolling friction, which does not depend on the robots;
//   2. robot k adds its contacts with partners 0..N-1 in partner order,
//      each evaluated from robot k's side on the posted pre-pass values;
//      where no pair of the warp's envs is within reach, every term is a
//      signed zero and only the zeros' signs are kept; lane 0 posts robot 0
//      (x, y, v_x, v_y, w, cos, sin);
//   3. every lane reads robot 0 back and runs the dribbler pull, the
//      vertical axis and the integration; robot k tests its kicker face for
//      rest_dribbler on the integrated (pre-push) ball, as physics/ssl.py
//      does, and posts its ball-contact term;
//   4. every lane sums, in robot order, the contact terms of the robots
//      that can touch the ball (the others' are zeros), then tests robot
//      0's infrared and applies the kick.
// Each pair is evaluated on both of its lanes: that costs issue slots, and
// saves the exchange of the pair terms and a __syncwarp (PERF.md, section 6:
// evaluating each pair once and posting its terms to partner slots was no
// faster).
//
// Why the results are ssl_body.cuh's to the bit: robot k receives its
// contact terms in the order of pair_collide.cuh's pass (pairs (0, k), ...,
// (k-1, k) subtracted, then (k, k+1), ..., (k, N-1) added: partner order),
// and each term from robot k's side is the exact negation of the lower
// robot's where pair_collide.cuh subtracts it (with the zero rule of step
// 2); adding a negated term rounds as subtracting it.  The contact sums
// start from 0 and add the terms in robot order, as the one-thread loop
// does, leaving out only zeros, which cannot change them; the dribbler
// pull, the ball's axis and the kick are the same expressions on the same
// values.  tests/test_torch_ssl_pair_order.py holds both orders bit-equal
// in torch, signs of zero included.
//
// Built with --fmad=false and no fast math (ops/_build.py).
#pragma once
#include "lane_group.cuh"
#include "ssl_body.cuh"

struct SslRobot {
  float x, y, th, vx, vy, w;
  float c, s;  // cos, sin of th: lane 0 recomputes them each substep
};

// robot 0 after the pair pass, as every lane reads it back
struct SslRobot0 {
  float x, y, vx, vy, w, c, s;
};

template <int N>
struct SslLayout {
  static_assert(N >= 2 && N <= kGroup, "one robot per lane");
  // a group's float4 slots in shared memory: robot states (8), contact
  // terms (8), robot 0 after the pair pass (2)
  static constexpr int kXs = 0, kCt = kGroup, kR0 = kCt + kGroup, kSlots = kR0 + 2;
};

// A pair or a ball contact whose squared distance d2 is finite and clears
// the square of its reach times (1 + 1e-4) cannot touch: reach - d2
// rsqrt(d2) < 0 there (the rsqrt's relative error is ~1e-7).  Every term
// of such a contact is a zero: the terms' factors f and g (the impulse j)
// select 0, and a finite difference times +0 is a zero of the difference's
// sign.
__device__ __forceinline__ bool ssl_far(float d2, float reach) {
  const float r = reach * 1.0001f;
  return d2 > r * r && d2 <= 3.402823466e38f;
}

__device__ __forceinline__ bool ssl_signbit(float v) { return (__float_as_uint(v) >> 31) != 0u; }

// v plus zeros that are all -0 (all_neg) or not: v itself but at a zero,
// which stays -0 only if v and every term are -0 (IEEE sums of zeros)
__device__ __forceinline__ float ssl_add_zeros(float v, bool all_neg) {
  return v == 0.0f ? ((ssl_signbit(v) && all_neg) ? -0.0f : 0.0f) : v;
}

// The terms robot a adds for its contact with robot b, from a's side, on
// the difference (dx, dy) and the squared distance d2 = fmaxf(dx^2 + dy^2,
// 1e-16): pair_collide.cuh's expressions.
template <class P>
__device__ __forceinline__ float4 ssl_pair_term(const P& p, float4 a, float4 b, float dx, float dy, float d2) {
  const float inv_d = rsqrt_normal(d2);
  const float overlap = p.two_r - d2 * inv_d;
  const bool col = overlap > 0.0f;
  const float f = (col ? 0.5f * overlap : 0.0f) * inv_d;
  const float rvx = a.z - b.z, rvy = a.w - b.w;
  const float vn = rvx * dx + rvy * dy;  // (v_rel . n) * d
  const float g = ((col && vn < 0.0f) ? p.pair_gain * vn : 0.0f) * (inv_d * inv_d);
  return make_float4(f * dx, f * dy, g * dx, g * dy);
}

// One substep of the env on this lane's group: k is the lane in the group,
// grp the group's SslLayout::kSlots slots.  (tu, tv, tw): this lane's
// robot's local velocity targets (zero but on lane 0); kick_vx0, drib0:
// robot 0's kicker and dribbler.  Leaves robot 0 after the pair pass in
// r0 and returns robot 0's infrared.  Called by every lane of the warp (it
// synchronises the warp).
template <int N, class P>
__device__ __forceinline__ bool ssl_substep(const P& p, int k, float4* grp, SslRobot& r, SslBall& bl, float tu,
                                            float tv, float tw, float kick_vx0, bool drib0, SslRobot0& r0) {
  using L = SslLayout<N>;
  float4* xs = grp + L::kXs;
  float4* ct = grp + L::kCt;
  float4* r0s = grp + L::kR0;

  // ---- 1. omni drive toward the local-frame target under accel clamps
  float u = r.vx * r.c + r.vy * r.s;
  float sl = -r.vx * r.s + r.vy * r.c;
  u = u + ssl_clampf(tu - u, -p.a_lin, p.a_lin);
  sl = sl + ssl_clampf(tv - sl, -p.a_lin, p.a_lin);
  r.w = r.w + ssl_clampf(tw - r.w, -p.a_ang, p.a_ang);
  r.th = ssl_wrap_angle(r.th + r.w * p.dts, p.pi, p.two_pi);
  if (k == 0) sincosf(r.th, &r.s, &r.c);
  r.vx = u * r.c - sl * r.s;
  r.vy = u * r.s + sl * r.c;
  r.x = r.x + r.vx * p.dts;
  r.y = r.y + r.vy * p.dts;
  const float4 own = make_float4(r.x, r.y, r.vx, r.vy);
  xs[k] = own;

  // ---- the ball: rolling friction while grounded
  const bool on_ground = bl.z <= p.ground_z;
  const float inv_speed = rsqrt_normal(bl.vx * bl.vx + bl.vy * bl.vy + 1e-16f);
  const float scale = fmaxf(0.0f, 1.0f - p.fric * inv_speed);
  if (on_ground) {
    bl.vx = bl.vx * scale;
    bl.vy = bl.vy * scale;
  }
  __syncwarp();

  // ---- 2. robot k's contacts with its partners 0..N-1 in partner order,
  // from the pre-pass values, each from robot k's side.  pair_collide.cuh
  // subtracts the lower robot's terms from the higher robot; from the
  // higher robot's side they are the exact negations of its own (IEEE
  // subtraction is sign-symmetric; a product of two negated factors is
  // unchanged) except where a coordinate difference is exactly 0: from
  // either side it is +0, and the negated term's zero is -0.  So from the
  // higher side a zero difference is taken as -0.
  // Partner j of robot k is robot q = j + (j >= k) (a lane past the robots,
  // k >= N, takes robots 0..N-2 and nothing reads it).
  float dxs[N - 1], dys[N - 1], d2s[N - 1];
  bool near = false, neg_x = true, neg_y = true;
#pragma unroll
  for (int j = 0; j < N - 1; ++j) {
    const int q = j + (j >= k ? 1 : 0);
    const float4 o = xs[q];
    float dx = own.x - o.x;
    float dy = own.y - o.y;
    if (q < k && dx == 0.0f) dx = -0.0f;
    if (q < k && dy == 0.0f) dy = -0.0f;
    dxs[j] = dx;
    dys[j] = dy;
    d2s[j] = fmaxf(dx * dx + dy * dy, 1e-16f);
    near = near || (k < N && !ssl_far(d2s[j], p.two_r));
    neg_x = neg_x && ssl_signbit(dx);
    neg_y = neg_y && ssl_signbit(dy);
  }
  if (__any_sync(kFullMask, near)) {
#pragma unroll
    for (int j = 0; j < N - 1; ++j) {
      const float4 t = ssl_pair_term(p, own, xs[j + (j >= k ? 1 : 0)], dxs[j], dys[j], d2s[j]);
      r.x = r.x + t.x;
      r.y = r.y + t.y;
      r.vx = r.vx + t.z;
      r.vy = r.vy + t.w;
    }
  } else {  // no pair of the warp touches: every term is a zero of dx's or dy's sign
    r.x = ssl_add_zeros(r.x, neg_x);
    r.vx = ssl_add_zeros(r.vx, neg_x);
    r.y = ssl_add_zeros(r.y, neg_y);
    r.vy = ssl_add_zeros(r.vy, neg_y);
  }
  if (k == 0) {
    r0s[0] = make_float4(r.x, r.y, r.vx, r.vy);
    r0s[1] = make_float4(r.w, r.c, r.s, 0.0f);
  }
  __syncwarp();

  // ---- 3. robot 0 back on every lane; the dribbler pulls the ball toward
  // robot 0's face point, damped against the face point's velocity
  {
    const float4 a = r0s[0], b = r0s[1];
    r0 = SslRobot0{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
  }
  float pull_x = 0.0f, pull_y = 0.0f;
  if (drib0) {
    const float rel_vx = bl.vx - (r0.vx - r0.w * p.face_dist * r0.s);
    const float rel_vy = bl.vy - (r0.vy + r0.w * p.face_dist * r0.c);
    const float rel_speed = sqrtf(rel_vx * rel_vx + rel_vy * rel_vy);
    if (ssl_face_zone(p, r0.x, r0.y, r0.c, r0.s, bl, p.reach_hi) && rel_speed < p.capture_speed) {
      pull_x = pull_x + (p.pull_accel * ((r0.x + p.face_dist * r0.c) - bl.x) - p.damping * rel_vx);
      pull_y = pull_y + (p.pull_accel * ((r0.y + p.face_dist * r0.s) - bl.y) - p.damping * rel_vy);
    }
  }
  bl.vx = bl.vx + pull_x * p.dts;
  bl.vy = bl.vy + pull_y * p.dts;

  // ---- vertical axis, then integrate
  bl.vz = bl.vz - p.gravity_dts;
  bl.z = bl.z + bl.vz * p.dts;
  const bool hit_floor = bl.z < p.r_ball;
  if (hit_floor && bl.vz < 0.0f) bl.vz = p.neg_rest_ground * bl.vz;
  if (hit_floor && bl.vz < p.bounce_min_v) bl.vz = 0.0f;
  if (hit_floor) bl.z = p.r_ball;
  bl.x = bl.x + bl.vx * p.dts;
  bl.y = bl.y + bl.vy * p.dts;

  // ---- ball vs robot k (the ball passes over above rbt_height); robot
  // 0's kicker face absorbs when it dribbles.  The term of a robot out of
  // reach, or under a ball above the top plate, is a zero (at a finite
  // distance), and a zero never changes a sum started from +0 (no partial
  // sum is -0): only the other robots' terms are summed, in robot order.
  float push_x = 0.0f, push_y = 0.0f, imp_x = 0.0f, imp_y = 0.0f;
  {
    const bool below_top = (bl.z - p.r_ball) < p.rbt_height;
    const float dx = bl.x - r.x;
    const float dy = bl.y - r.y;
    const float d2 = fmaxf(dx * dx + dy * dy, 1e-16f);
    const bool zero = ssl_far(d2, p.r_sum) || (!below_top && d2 <= 3.402823466e38f);
    const unsigned touch = __ballot_sync(kFullMask, k < N && !zero);
    if (touch) {
      const bool absorb = k == 0 && drib0 && ssl_face_zone(p, r.x, r.y, r.c, r.s, bl, p.contact_hi);
      const float inv_d = rsqrt_normal(d2);
      const float overlap = p.r_sum - d2 * inv_d;
      const bool col = overlap > 0.0f && below_top;
      const float nx = dx * inv_d, ny = dy * inv_d;
      const float vn = (bl.vx - r.vx) * nx + (bl.vy - r.vy) * ny;
      const float gain = absorb ? p.drib_gain : p.ball_gain;
      const float j = (col && vn < 0.0f) ? gain * vn : 0.0f;
      ct[k] = make_float4((col ? overlap : 0.0f) * nx, (col ? overlap : 0.0f) * ny, j * nx, j * ny);
      __syncwarp();

      // ---- 4. the contact terms in robot order
      for (unsigned m = (touch >> (threadIdx.x & 24u)) & 0xffu; m != 0u; m &= m - 1u) {
        const float4 c = ct[__ffs(m) - 1];
        push_x = push_x + c.x;
        push_y = push_y + c.y;
        imp_x = imp_x + c.z;
        imp_y = imp_y + c.w;
      }
    }
  }
  bl.x = bl.x + push_x;
  bl.y = bl.y + push_y;
  bl.vx = bl.vx + imp_x;
  bl.vy = bl.vy + imp_y;

  // ---- robot 0's infrared; the kick along its heading
  const bool ir0 = ssl_face_zone(p, r0.x, r0.y, r0.c, r0.s, bl, p.contact_hi);
  if (ir0 && kick_vx0 > 0.0f) {
    bl.vx = kick_vx0 * r0.c;
    bl.vy = kick_vx0 * r0.s;
  }
  return ir0;
}
