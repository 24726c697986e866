// What both designs of the fused VSS step share (vss_full.cu: the group
// kernel; vss_thread.cu: the one-thread kernel): the parameter struct, the
// wheel conversion and the step's outcome.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "vss_world.cuh"

#define VSS_PARAMS(X)                                                                           \
  X(dt) X(dts) X(lat_keep) X(a_lin) X(a_ang) X(max_wheel) X(wheel_r) X(two_half_axle)          \
  X(ou_theta) X(ou_sig_sqdt) X(max_v) X(deadzone)                                               \
  X(half_len) X(half_wid) X(goal_half) X(hl_goal) X(r_ball) X(two_r) X(r_sum) X(xl) X(yl)       \
  X(ground_z) X(fric) X(gravity_dts) X(neg_rest_ground) X(bounce_min_v) X(rbt_height)           \
  X(pair_gain) X(ball_gain) X(neg_rest_wall)                                                    \
  X(half_l_pot) X(length100) X(max_steps)                                                       \
  X(max_pos) X(max_w_rad) X(nbnd)                                                               \
  X(x_lo) X(x_span) X(y_lo) X(y_span) X(min_d2) X(two_pi) X(pi)

struct VssParams {
#define VSS_FIELD(n) float n;
  VSS_PARAMS(VSS_FIELD)
#undef VSS_FIELD
};

namespace {

constexpr int K = 8;  // spawn candidates per entity (envs/spawn.N_CANDIDATES)
constexpr int kSubsteps = 5;  // PhysicsConfig.n_substeps (the wrapper checks)

__device__ __forceinline__ float to_wheel(float a, const VssParams& p) {
  float v = clampf(a * p.max_v, -p.max_v, p.max_v);
  v = fabsf(v) < p.deadzone ? 0.0f : v;
  return v / p.wheel_r;
}

// The step's outcome (envs/vss.post_physics): reward cascade, shaping
// accumulators, truncation, from the post-substep ball and robot 0 (its
// x, y, v_x, v_y and its wheel speeds before the clamp).  Both designs
// call it on the same values.
struct VssOutcome {
  float potential, reward, steps_new, shaping[6];
  bool goal, trunc, done;
};

__device__ __forceinline__ VssOutcome vss_outcome(const VssParams& p, const VssBall& ball, float x0, float y0,
                                                  float vx0, float vy0, float wl0, float wr0, float steps,
                                                  float ball_pot, float has_pot, const float (&shaping)[6]) {
  VssOutcome o;
  const float bx = ball.x, by = ball.y;
  const bool goal_blue = bx > p.half_len;
  const bool goal_yellow = bx < -p.half_len;
  o.goal = goal_blue || goal_yellow;
  const float dx_d = (p.half_l_pot + bx) * 100.0f;
  const float dx_a = (p.half_l_pot - bx) * 100.0f;
  const float dyc = by * 100.0f;
  const float dist_1 = -sqrtf(dx_a * dx_a + 2.0f * dyc * dyc);
  const float dist_2 = sqrtf(dx_d * dx_d + 2.0f * dyc * dyc);
  o.potential = ((dist_1 + dist_2) / p.length100 - 1.0f) / 2.0f;
  const float grad = has_pot > 0.5f ? clampf((o.potential - ball_pot) * 3.0f / p.dt, -5.0f, 5.0f) : 0.0f;

  float rbx = bx - x0, rby = by - y0;
  const float inv_rb = rsqrtf(fmaxf(rbx * rbx + rby * rby, 1e-16f));
  rbx = rbx * inv_rb;
  rby = rby * inv_rb;
  const float move = clampf((rbx * vx0 + rby * vy0) / 0.4f, -5.0f, 5.0f);
  const float energy = -(fabsf(wl0) + fabsf(wr0));
  const float shaped = 0.2f * move + 0.8f * grad + 2e-4f * energy;
  o.reward = goal_blue ? 10.0f : (goal_yellow ? -10.0f : shaped);

  o.shaping[0] = shaping[0] + (o.goal ? (goal_blue ? 1.0f : -1.0f) : 0.0f);
  o.shaping[1] = shaping[1] + (o.goal ? 0.0f : 0.2f * move);
  o.shaping[2] = shaping[2] + (o.goal ? 0.0f : 0.8f * grad);
  o.shaping[3] = shaping[3] + (o.goal ? 0.0f : 2e-4f * energy);
  o.shaping[4] = shaping[4] + (o.goal ? (float)goal_blue : 0.0f);
  o.shaping[5] = shaping[5] + (o.goal ? (float)goal_yellow : 0.0f);

  o.steps_new = steps + 1.0f;
  o.trunc = o.steps_new >= p.max_steps;
  o.done = o.goal || o.trunc;
  return o;
}

}  // namespace
