// SSL world step for one env in registers: the __device__ twin of
// rsoccer_tpu_torch/physics/ssl.py, replacing the TPU kernels' shared body
// rsoccer_tpu/ops/pallas_ssl_full.py:90 (make_ssl_physics_body).
//
// Per substep: omni drive toward the local-frame target under accel clamps
// -> heading wrap -> integrate -> pair-list robot contacts -> ball rolling
// friction (grounded) -> dribbler pull toward each dribbling robot's
// kicker face, summed in robot order -> vertical ball axis -> integrate ->
// ball-robot contacts, a dribbling robot's face absorbing (rest_dribbler)
// on the PRE-resolve ball position as physics/ssl.py does (the TPU body
// tests the face after the push) -> kick -> infrared of every robot.
//
// Contract (every SSL task drives blue robot 0 only): robots 1..N-1 get
// zero targets and no kick, and enter with w = 0, so their w stays exactly
// 0 and their heading never turns.  Robot 0 gets exact sin/cos each
// substep (one sincosf: sinf's and cosf's bits on every f32, checked on the
// card by tools/thread_probe --parts sincos); the others ride the trig
// carried in from the step's start (the plain version recomputes it: a few
// ulp).  Every 1 / sqrt is of a normal argument (>= 1e-16): rsqrt_normal
// (pair_collide.cuh).  Robot 0 dribbles when `drib0` says so; DRIB_ON is
// the compile-time mask of robots whose dribbler is always on
// (PassEndurance's receiver: bit 1).  SD, CP and Dribbling pass 0, and for
// them the body compiles to what it was before the mask.
#pragma once
#include "pair_collide.cuh"

constexpr int kSslSubsteps = 5;  // PhysicsConfig.n_substeps (the wrapper checks)

struct SslBall {
  float x, y, z, vx, vy, vz;
};

__device__ __forceinline__ float ssl_clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

// jnp.mod / torch.remainder(t + pi, 2 pi) - pi: fmodf takes the dividend's
// sign, so a negative remainder moves up by one period (floor-mod).  In
// [0, 2 pi) fmodf returns its argument exactly, so it is skipped there (a
// NaN fails the test and takes fmodf): the same bits on every f32.  The
// one wrap of every SSL kernel (the group world step of ssl_world.cuh
// too).
__device__ __forceinline__ float ssl_wrap_angle(float t, float pi, float two_pi) {
  float r = t + pi;
  if (!(r >= 0.0f && r < two_pi)) {
    r = fmodf(r, two_pi);
    if (r != 0.0f && r < 0.0f) r += two_pi;
  }
  return r - pi;
}

// ball centre inside the kicker-face window of a robot at (rx, ry) with
// heading trig (c, s), out to `hi` along the heading, low enough for the
// kicker plate (physics/ssl.make_face_zone)
template <class P>
__device__ __forceinline__ bool ssl_face_zone(const P& p, float rx, float ry, float c, float s, const SslBall& bl,
                                              float hi) {
  const float dx = bl.x - rx;
  const float dy = bl.y - ry;
  const float lx = dx * c + dy * s;
  const float ly = -dx * s + dy * c;
  return lx >= p.contact_lo && lx <= hi && fabsf(ly) <= p.half_kick_w && (bl.z - p.r_ball) <= p.kicker_height;
}

// One control step (kSslSubsteps substeps).  (c, s): the heading trig at
// the step's start in, the final trig out.  (tu0, tv0, tw0): robot 0's
// local velocity target; kick_vx0 / kick_vz0 / drib0 its kicker and
// dribbler.  ir: every robot's infrared from the last substep.
template <int N, unsigned DRIB_ON, class P>
__device__ __forceinline__ void ssl_world_step(const P& p, float (&x)[N], float (&y)[N], float (&th)[N],
                                               float (&vx)[N], float (&vy)[N], float (&w)[N], float (&c)[N],
                                               float (&s)[N], SslBall& bl, float tu0, float tv0, float tw0,
                                               float kick_vx0, float kick_vz0, bool drib0, bool (&ir)[N]) {
  static_assert(N <= 32 && (DRIB_ON >> N) == 0u, "DRIB_ON names robots 0..N-1");
  bool drib[N];
#pragma unroll
  for (int r = 0; r < N; ++r) drib[r] = ((DRIB_ON >> r) & 1u) != 0u || (r == 0 && drib0);
#pragma unroll 1  // kept rolled: the unrolled body would be 5x the code
  for (int sub = 0; sub < kSslSubsteps; ++sub) {
    // ---- omni drive
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float tu = r == 0 ? tu0 : 0.0f;
      const float tv = r == 0 ? tv0 : 0.0f;
      const float tw = r == 0 ? tw0 : 0.0f;
      float u = vx[r] * c[r] + vy[r] * s[r];
      float sl = -vx[r] * s[r] + vy[r] * c[r];
      u = u + ssl_clampf(tu - u, -p.a_lin, p.a_lin);
      sl = sl + ssl_clampf(tv - sl, -p.a_lin, p.a_lin);
      w[r] = w[r] + ssl_clampf(tw - w[r], -p.a_ang, p.a_ang);
      th[r] = ssl_wrap_angle(th[r] + w[r] * p.dts, p.pi, p.two_pi);
      if (r == 0) sincosf(th[0], &s[0], &c[0]);
      vx[r] = u * c[r] - sl * s[r];
      vy[r] = u * s[r] + sl * c[r];
      x[r] = x[r] + vx[r] * p.dts;
      y[r] = y[r] + vy[r] * p.dts;
    }
    resolve_pair_collisions<N>(x, y, vx, vy, p.two_r, p.pair_gain);

    // ---- ball: rolling friction while grounded
    const bool on_ground = bl.z <= p.ground_z;
    const float inv_speed = rsqrt_normal(bl.vx * bl.vx + bl.vy * bl.vy + 1e-16f);
    const float scale = fmaxf(0.0f, 1.0f - p.fric * inv_speed);
    if (on_ground) {
      bl.vx = bl.vx * scale;
      bl.vy = bl.vy * scale;
    }

    // ---- dribbler: spring-damper toward each dribbling robot's face
    // point, damped against the face point's velocity (incl. omega x r)
    float pull_x = 0.0f, pull_y = 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (!drib[r]) continue;
      const float rel_vx = bl.vx - (vx[r] - w[r] * p.face_dist * s[r]);
      const float rel_vy = bl.vy - (vy[r] + w[r] * p.face_dist * c[r]);
      const float rel_speed = sqrtf(rel_vx * rel_vx + rel_vy * rel_vy);
      if (ssl_face_zone(p, x[r], y[r], c[r], s[r], bl, p.reach_hi) && rel_speed < p.capture_speed) {
        pull_x = pull_x + (p.pull_accel * ((x[r] + p.face_dist * c[r]) - bl.x) - p.damping * rel_vx);
        pull_y = pull_y + (p.pull_accel * ((y[r] + p.face_dist * s[r]) - bl.y) - p.damping * rel_vy);
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

    // ---- ball vs robots (the ball passes over above rbt_height)
    const bool below_top = (bl.z - p.r_ball) < p.rbt_height;
    bool absorb[N];
#pragma unroll
    for (int r = 0; r < N; ++r) absorb[r] = drib[r] && ssl_face_zone(p, x[r], y[r], c[r], s[r], bl, p.contact_hi);
    float push_x = 0.0f, push_y = 0.0f, imp_x = 0.0f, imp_y = 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float dx = bl.x - x[r];
      const float dy = bl.y - y[r];
      const float d2 = fmaxf(dx * dx + dy * dy, 1e-16f);
      const float inv_d = rsqrt_normal(d2);
      const float overlap = p.r_sum - d2 * inv_d;
      const bool col = overlap > 0.0f && below_top;
      const float nx = dx * inv_d, ny = dy * inv_d;
      push_x += (col ? overlap : 0.0f) * nx;
      push_y += (col ? overlap : 0.0f) * ny;
      const float vn = (bl.vx - vx[r]) * nx + (bl.vy - vy[r]) * ny;
      const float gain = absorb[r] ? p.drib_gain : p.ball_gain;
      const float j = (col && vn < 0.0f) ? gain * vn : 0.0f;
      imp_x += j * nx;
      imp_y += j * ny;
    }
    bl.x = bl.x + push_x;
    bl.y = bl.y + push_y;
    bl.vx = bl.vx + imp_x;
    bl.vy = bl.vy + imp_y;

    // ---- infrared; kick (and chip) along robot 0's heading
#pragma unroll
    for (int r = 0; r < N; ++r) ir[r] = ssl_face_zone(p, x[r], y[r], c[r], s[r], bl, p.contact_hi);
    if (ir[0] && kick_vx0 > 0.0f) {
      bl.vx = kick_vx0 * c[0];
      bl.vy = kick_vx0 * s[0];
      if (kick_vz0 > 0.0f) bl.vz = kick_vz0;
    }
  }
}
