// The score loop shared by ei_diff.cu and fused_sample_ei.cu: the
// log-density of a Gaussian mixture at x as a streaming log-sum-exp in
// base 2, with everything that depends on the component alone hoisted out
// of the candidate loop.
//
// Per component (computed once per block, while the component is staged
// into shared memory):
//
//   c  = log2(e) * (log max(w, 1e-12) - log s - log sqrt(2 pi))   (w > 0)
//      = -1e30 * log2(e)                                          (w <= 0)
//   k  = sqrt(log2(e) / 2) / s
//   mu
//
// so that log2(w N(x; mu, s)) = c - ((x - mu) k)^2: one subtraction, one
// multiply and one FMA per candidate x component.  The carry (mx, se)
// holds lse2 = mx + log2(se) and takes one exp2 per term:
//
//   d = t - mx;  e = exp2(-|d|);  se = d > 0 ? se * e + 1 : se + e;
//   mx = max(mx, t)
//
// and log(sum) = ln 2 * (mx + log2(se)).  A dead component's term stays at
// about -1.44e30, as the plain version's stays at -1e30, so an all-dead
// mixture scores -1e30 there and about -1e30 here.  Two carries merge as
// M = max(mx1, mx2), se = se1 exp2(mx1 - M) + se2 exp2(mx2 - M).
//
// Intrinsics, chosen on purpose (the sources build without
// -use_fast_math): the term's exp2 is PTX ex2.approx.ftz.f32, one
// special-function (MUFU.EX2) result and nothing else.  Its argument is
// <= 0, so its result lies in (0, 1]; flushing a result below 2^-126 to 0
// drops less than 1e-38 of a sum that already holds a 1.  CUDA's exp2f
// would add a subnormal range fix-up around the same MUFU op, and expf a
// multiply by log2(e) and a correction.  The per-component constants use
// the accurate logf and an IEEE division: they cost one evaluation per
// component and block, not per term, and keep c and k to an ulp.  The
// final log2f runs once per candidate.

#pragma once

#include <cuda_runtime.h>

namespace mixture_lse {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kDead2 = -1.4426950408889634e30f;   // -1e30 * log2(e)
constexpr float kLogSqrt2Pi = 0.9189385332046727f;  // log(sqrt(2 pi))
constexpr float kSqrtHalfLog2e = 0.8493218002880191f;  // sqrt(log2(e) / 2)

// One component's hoisted constants; w is laid out last so that a staged
// float4 reads as {c, k, mu, unused}.
__device__ __forceinline__ float4 make_term(float w, float mu, float s) {
  const float c = w > 0.0f
      ? kLog2e * ((logf(fmaxf(w, 1e-12f)) - logf(s)) - kLogSqrt2Pi)
      : kDead2;
  return make_float4(c, kSqrtHalfLog2e / s, mu, 0.0f);
}

__device__ __forceinline__ float ex2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

struct Carry {
  float mx, se;
};

__device__ __forceinline__ Carry empty_carry() { return {-__int_as_float(0x7f800000), 0.0f}; }

// Adds the term of component `t` ({c, k, mu}) at x to the carry.
__device__ __forceinline__ void step(const float4& t, float x, Carry& a) {
  const float y = (x - t.z) * t.y;
  const float term = fmaf(-y, y, t.x);
  const float d = term - a.mx;
  const float e = ex2_ftz(-fabsf(d));
  const bool up = d > 0.0f;
  a.se = fmaf(a.se, up ? e : 1.0f, up ? 1.0f : e);
  a.mx = fmaxf(a.mx, term);
}

// Folds carry `b` into `a`.
__device__ __forceinline__ void merge(Carry& a, const Carry& b) {
  if (b.se == 0.0f) return;  // an empty carry adds nothing
  if (a.se == 0.0f) {
    a = b;
    return;
  }
  const float M = fmaxf(a.mx, b.mx);
  a.se = a.se * ex2_ftz(a.mx - M) + b.se * ex2_ftz(b.mx - M);
  a.mx = M;
}

// log(below mixture) - log(above mixture), in natural units.
__device__ __forceinline__ float score(const Carry& b, const Carry& a) {
  return kLn2 * ((b.mx + log2f(b.se)) - (a.mx + log2f(a.se)));
}

}  // namespace mixture_lse
