// The softened-gravity pair term shared by the all-pairs kernels
// (csrc/naive_forces.cu, B1 and B2), the group walk's evaluation kernel
// (csrc/tree_walk_group.cu, B4) and the per-particle walk (csrc/tree_walk.cu,
// B3, which also takes its theta test's first guess from the same rsqrt).
// The energy kernel (csrc/energy.cu, E1) takes only rsqrt_ftz, for its far
// pairs. The pair term:
//
//     d = p_j - p_i,  r2 = |d|^2,  inv_r = rsqrt(r2),
//     w = mgdt_j * inv_r / (r2 * (r2 * inv_r) + e)        mgdt_j = m_j * g * dt
//
// The rsqrt and the divide are the flush-to-zero approximations (one MUFU
// each, and one FMUL for the divide), without the fix-ups for subnormal
// inputs that rsqrtf and an IEEE divide carry: r2 and the denominator are
// normal unless two bodies lie within ~1e-19 of each other, where the pair
// gives NaN (two distinct coincident bodies give NaN in every version).
// The build keeps --use_fast_math off; only these two operations are
// approximate. 15 SASS instructions per pair with the dx-form sum below.
#pragma once

// 1 / sqrt(x), one MUFU (relative error at most 2^-22.9, subnormals flushed).
__device__ __forceinline__ float rsqrt_ftz(const float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The weight of a pair at squared distance r2 whose inv_r = rsqrt_ftz(r2)
// is at hand: mgdt * inv_r / (r2 * r + e).
__device__ __forceinline__ float weight_from(const float mgdt, const float r2, const float inv_r,
                                             const float e) {
  float w;
  asm("div.approx.ftz.f32 %0, %1, %2;" : "=f"(w) : "f"(mgdt * inv_r), "f"(r2 * (r2 * inv_r) + e));
  return w;
}

// The weight w of one pair with offset (dx, dy, dz) to source s (xyz,
// mgdt). With SELF, a self pair (r2 == 0) is evaluated at r2 = 1 and
// weighted 0.
template <bool SELF>
__device__ __forceinline__ float pair_weight(const float4 s, const float dx, const float dy,
                                             const float dz, const bool self, const float e) {
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float r2s = SELF && self ? 1.0f : r2;
  float w = weight_from(s.w, r2s, rsqrt_ftz(r2s), e);
  if (SELF) w = self ? 0.0f : w;
  return w;
}

// One receiver-row pair, dx-form: acc += w * d.
template <bool SELF>
__device__ __forceinline__ void pair_term(const float4 s, const float px, const float py,
                                          const float pz, const bool self, const float e,
                                          float& ax, float& ay, float& az) {
  const float dx = s.x - px;
  const float dy = s.y - py;
  const float dz = s.z - pz;
  const float w = pair_weight<SELF>(s, dx, dy, dz, self, e);
  ax += w * dx;
  ay += w * dy;
  az += w * dz;
}

// One receiver-row pair, factored: S += w * p_j, S_w += w (resolved as
// S - p_i * S_w after the last source).
template <bool SELF>
__device__ __forceinline__ void pair_term_factored(const float4 s, const float px,
                                                   const float py, const float pz,
                                                   const bool self, const float e, float4& acc) {
  const float w = pair_weight<SELF>(s, s.x - px, s.y - py, s.z - pz, self, e);
  acc.x += w * s.x;
  acc.y += w * s.y;
  acc.z += w * s.z;
  acc.w += w;
}
