// The bounce of one lane, shared by the three bounce kernels:
// regen_bounce.cu (B1, regeneration + bounce), bounce.cu (B2, one bounce
// of an explicit state, optionally with an external triangle hit) and
// bounce_bwd.cu (B5, the bounce's VJP); and the sphere test, which the
// sphere-winner kernel (sphere_winner.cu, B6) shares with the bounce's
// sweep. kRich (B1, B2) holds every family of the JAX kernel beyond the
// lean bounce: the media sweep and the specular branch (metal, dielectric,
// isotropic) of srt_tpu/pallas/bounce.py:486-542 and 663-729, checker,
// Perlin-marble and image textures on any material (_shade_core,
// :626-661, which defers noise and image albedo to an XLA epilogue;
// here they are evaluated in the kernel, the Perlin tables staged in
// shared memory), and sphere lights (:800-821, :844-860); the lean
// instantiations (ball_scenes' B1, cornell_boxes' B2, the lean B5's
// shade<Dual<7>>) compile without any of it. The rich helpers are written
// over the scalar type as shade<T> is, so B5's rich instantiation
// (bounce_bwd.cu's kRich) differentiates them: the media event's distance,
// the specular branch, the checker's colours, the marble in the hit
// point, sphere-light samples and pdfs; an image lookup has no tangent
// (nearest texel).
// kMoving (B1, B2) puts each sphere at its centre at the ray's time, as
// the JAX kernels' ``moving`` static does; the static instantiations do
// not read the time. B6 always lerps, as the JAX sphere kernel does.
// kParity (B2 only, float only) is the reference-parity estimator of
// srt_tpu/pallas/bounce.py:930-1030 (diffuse_parity): light-only diffuse
// lobes, the heap slot, bounded retries, the Beckmann frame of the raw
// stored normal, the broken Erf and the as-implemented pdf and weight.
//
// The closest-hit sweep runs in float, over sphere records staged in
// shared memory as three float4s (stage_spheres): one test, sphere_t, for
// B1, B2, B5 and B6. B1, B2 and B5 split a lane's sphere sweep over
// threads of their own (sphere_share), which meet in nearest_share and
// finish_hit with closest_hit's winner. Everything after it, the shading
// (shade<T>), is written once over a scalar type T:
//   * T = float for the forward kernels;
//   * T = Dual<K>, a value with K forward-mode tangents, for the backward
//     kernel, which replays the same code to take the Jacobian columns it
//     needs. The value part of every Dual operation is the float
//     operation, so the replay takes every branch the forward took.
// The tangent rules are those of the JAX package's backward kernel
// (srt_tpu/pallas/bounce.py:111-154) and of the plain PyTorch version
// (srt_tpu_torch/core/gradsafe.py): a sqrt tangent of 0 where x <= 0, and
// every division's denominator coefficient clamped to +-3e37. min/max
// pass the first argument's tangent on a tie, as torch.clamp does; where a
// tie is structural (a ray starting on a medium's face, hit_t) the tangent
// is halved, as jnp.maximum and torch.maximum split it.
//
// The arithmetic follows the plain PyTorch version
// (srt_tpu_torch/render/integrator.py:bounce_step) operation by operation,
// in the same order; build with --fmad=false and without --use_fast_math
// so the two differ only by libm ulps.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srt {

constexpr float kBig = 3.0e38f;
constexpr float kTPosMax = 1.0e7f;
constexpr float kTMin = 1e-3f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kSqrtPiInv = 0.5641895835477563f;
constexpr float kCoefMax = 3e37f;
constexpr int kLambertian = 0, kOrenNayar = 1, kBeckmann = 2, kMetal = 3,
              kDielectric = 4, kDiffuseLight = 5, kIsotropic = 6;
constexpr int kTexChecker = 1, kTexNoise = 2, kTexImage = 3;
constexpr int kLightSphere = 1;
constexpr float kInv4Pi = 0.0795774715459476678f;
constexpr int kPerlin = 256;     // entries of each Perlin table
constexpr int kOctaves = 7;      // perlin_turb's depth (perlin.h:48-58)

// ---- scalar types: float, and Dual<K> ------------------------------------
template <int K>
struct Dual {
  float v;
  float t[K];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(float x) : v(x) {
#pragma unroll
    for (int i = 0; i < K; ++i) t[i] = 0.0f;
  }
};

__device__ __forceinline__ float val(float x) { return x; }
template <int K>
__device__ __forceinline__ float val(const Dual<K>& x) { return x.v; }

__device__ __forceinline__ float clamp_coef(float c) {
  return fminf(fmaxf(c, -kCoefMax), kCoefMax);
}

template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a) {
  Dual<K> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = -a.t[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator+(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = a.t[i] + b.t[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator+(const Dual<K>& a, float b) {
  Dual<K> r = a;
  r.v = a.v + b;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator+(float a, const Dual<K>& b) {
  Dual<K> r = b;
  r.v = a + b.v;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = a.t[i] - b.t[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a, float b) {
  Dual<K> r = a;
  r.v = a.v - b;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator-(float a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = -b.t[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator*(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = a.t[i] * b.v + b.t[i] * a.v;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator*(const Dual<K>& a, float b) {
  Dual<K> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = a.t[i] * b;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator*(float a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = a * b.t[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator/(const Dual<K>& a,
                                             const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v / b.v;
  const float inv = 1.0f / b.v;
  const float coef = clamp_coef(-(a.v * inv) * inv);
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = a.t[i] * inv + b.t[i] * coef;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator/(const Dual<K>& a, float b) {
  Dual<K> r;
  r.v = a.v / b;
  const float inv = 1.0f / b;
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = a.t[i] * inv;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator/(float a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a / b.v;
  const float inv = 1.0f / b.v;
  const float coef = clamp_coef(-(a * inv) * inv);
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = b.t[i] * coef;
  return r;
}

// a function of the value with derivative ``df`` at it
template <int K>
__device__ __forceinline__ Dual<K> chain(const Dual<K>& x, float v,
                                         float df) {
  Dual<K> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.t[i] = x.t[i] * df;
  return r;
}

__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
template <int K>
__device__ __forceinline__ Dual<K> xsqrt(const Dual<K>& x) {
  const float v = sqrtf(x.v);
  return chain(x, v, x.v > 0.0f ? 0.5f / v : 0.0f);
}
__device__ __forceinline__ float xexp(float x) { return expf(x); }
template <int K>
__device__ __forceinline__ Dual<K> xexp(const Dual<K>& x) {
  const float v = expf(x.v);
  return chain(x, v, v);
}
__device__ __forceinline__ float xlog(float x) { return logf(x); }
template <int K>
__device__ __forceinline__ Dual<K> xlog(const Dual<K>& x) {
  return chain(x, logf(x.v), 1.0f / x.v);
}
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
template <int K>
__device__ __forceinline__ Dual<K> xabs(const Dual<K>& x) {
  return chain(x, fabsf(x.v), x.v > 0.0f ? 1.0f : (x.v < 0.0f ? -1.0f : 0.0f));
}
__device__ __forceinline__ float xmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float xmin(float a, float b) { return fminf(a, b); }
template <int K>
__device__ __forceinline__ Dual<K> xmax(const Dual<K>& a, float b) {
  const float v = fmaxf(a.v, b);
  if (v == a.v) return a;
  return Dual<K>(v);
}
template <int K>
__device__ __forceinline__ Dual<K> xmin(const Dual<K>& a, float b) {
  const float v = fminf(a.v, b);
  if (v == a.v) return a;
  return Dual<K>(v);
}
template <int K>
__device__ __forceinline__ Dual<K> xmax(const Dual<K>& a, const Dual<K>& b) {
  const float v = fmaxf(a.v, b.v);
  return v == a.v ? a : b;
}
template <int K>
__device__ __forceinline__ Dual<K> xmin(const Dual<K>& a, const Dual<K>& b) {
  const float v = fminf(a.v, b.v);
  return v == a.v ? a : b;
}
__device__ __forceinline__ float xsin(float x) { return sinf(x); }
template <int K>
__device__ __forceinline__ Dual<K> xsin(const Dual<K>& x) {
  return chain(x, sinf(x.v), cosf(x.v));
}
template <class T>
__device__ __forceinline__ T xclamp(const T& x, float lo, float hi) {
  return xmin(xmax(x, lo), hi);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
// 1/x with |x| < 1e-20 replaced by +1e-20 (a ray's reciprocal direction)
__device__ __forceinline__ float safe_inv(float x) {
  return 1.0f / (fabsf(x) < 1e-20f ? 1e-20f : x);
}
// sqrt(max(x, 0)), +0 where x <= 0 (vecmath.safe_sqrt), its tangent 0
// there (_grad_safe_sqrt)
__device__ __forceinline__ float sqrt_pos(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}
template <int K>
__device__ __forceinline__ Dual<K> sqrt_pos(const Dual<K>& x) {
  return x.v > 0.0f ? xsqrt(x) : Dual<K>(0.0f);
}

// ---- 3-vectors -------------------------------------------------------------
template <class T>
struct V3T {
  T x, y, z;
};
using V3 = V3T<float>;

template <class T>
__device__ __forceinline__ V3T<T> v3(T x, T y, T z) {
  V3T<T> r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
template <class T>
__device__ __forceinline__ V3T<T> lift3(V3 a) {
  return v3<T>(T(a.x), T(a.y), T(a.z));
}
template <class T>
__device__ __forceinline__ V3 val3(const V3T<T>& a) {
  return v3(val(a.x), val(a.y), val(a.z));
}
template <class T>
__device__ __forceinline__ V3T<T> add(const V3T<T>& a, const V3T<T>& b) {
  return v3<T>(a.x + b.x, a.y + b.y, a.z + b.z);
}
template <class T>
__device__ __forceinline__ V3T<T> sub(const V3T<T>& a, const V3T<T>& b) {
  return v3<T>(a.x - b.x, a.y - b.y, a.z - b.z);
}
template <class T, class S>
__device__ __forceinline__ V3T<T> scale(const V3T<T>& a, const S& s) {
  return v3<T>(a.x * s, a.y * s, a.z * s);
}
template <class T, class S>
__device__ __forceinline__ V3T<T> divide(const V3T<T>& a, const S& s) {
  return v3<T>(a.x / s, a.y / s, a.z / s);
}
template <class T>
__device__ __forceinline__ V3T<T> neg(const V3T<T>& a) {
  return v3<T>(-a.x, -a.y, -a.z);
}
template <class T>
__device__ __forceinline__ T dot(const V3T<T>& a, const V3T<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <class T>
__device__ __forceinline__ V3T<T> cross(const V3T<T>& a, const V3T<T>& b) {
  return v3<T>(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
               a.x * b.y - a.y * b.x);
}
template <class T>
__device__ __forceinline__ V3T<T> normalize(const V3T<T>& a) {
  T inv = 1.0f / xmax(xsqrt(dot(a, a)), 1e-20f);
  return scale(a, inv);
}
template <class T>
__device__ __forceinline__ V3T<T> safe_normalize(const V3T<T>& a) {
  T l2 = dot(a, a);
  bool ok = val(l2) > 1e-12f;
  return divide(ok ? a : v3<T>(T(0.0f), T(0.0f), T(1.0f)),
                xsqrt(ok ? l2 : T(1.0f)));
}
// times the reciprocal length, +z for |a|^2 <= 1e-12 (the JAX kernel's
// _safe_normalize3)
template <class T>
__device__ __forceinline__ V3T<T> safe_normalize_rcp(const V3T<T>& a) {
  const T l2 = dot(a, a);
  const bool ok = val(l2) > 1e-12f;
  const T inv = 1.0f / xsqrt(ok ? l2 : T(1.0f));
  return scale(ok ? a : v3<T>(T(0.0f), T(0.0f), T(1.0f)), inv);
}
template <class T>
__device__ __forceinline__ T comp(const V3T<T>& a, int axis) {
  return axis == 0 ? a.x : (axis == 1 ? a.y : a.z);
}
template <class T>
__device__ __forceinline__ void set_comp(V3T<T>& a, int axis, T v) {
  if (axis == 0) a.x = v;
  else if (axis == 1) a.y = v;
  else a.z = v;
}
// (n, 3) rows
__device__ __forceinline__ V3 load_row3(const float* p, int i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store_row3(float* p, int i, V3 a) {
  p[3 * i] = a.x;
  p[3 * i + 1] = a.y;
  p[3 * i + 2] = a.z;
}

// ---- counter RNG (srt_tpu_torch/core/rng.py) ---------------------------
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return mix(mix(a) + (b ^ 0x9E3779B9u));
}
__device__ __forceinline__ float uniform(uint32_t salt, uint32_t dim) {
  uint32_t bits = hash_combine(salt, 0xB5297A4Du + 0x68E31DA4u * dim);
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// ---- special-function fits (core/approx.py) ----------------------------
template <class T>
__device__ T erf_as(const T& x) {
  float s = signf(val(x));
  T ax = xabs(x);
  T t = 1.0f / (1.0f + 0.3275911f * ax);
  T y = 1.0f - (((((1.061405429f * t - 1.453152027f) * t) + 1.421413741f)
                 * t - 0.284496736f) * t + 0.254829592f)
               * t * xexp(-ax * ax);
  return s * y;
}

// The reference's Erf as implemented (common.h:40-44, core/approx.py:
// erf_reference_buggy): the exponential is added, not multiplied in.
template <class T>
__device__ T erf_reference_buggy(const T& x) {
  float s = signf(val(x));
  T ax = xabs(x);
  T t = 1.0f / (1.0f + 0.3275911f * ax);
  T poly_t = (((((1.061405429f * t - 1.453152027f) * t) + 1.421413741f)
               * t - 0.284496736f) * t + 0.254829592f) * t;
  return s * (1.0f - poly_t + xexp(-ax * ax));
}

template <class T>
__device__ T erfinv_giles(T x) {
  x = xclamp(x, -0.99999f, 0.99999f);
  T w = -xlog(xmax((1.0f - x) * (1.0f + x), 1e-30f));
  T wc = w - 2.5f;
  T p = T(2.81022636e-08f);
  p = 3.43273939e-07f + p * wc;
  p = -3.5233877e-06f + p * wc;
  p = -4.39150654e-06f + p * wc;
  p = 0.00021858087f + p * wc;
  p = -0.00125372503f + p * wc;
  p = -0.00417768164f + p * wc;
  p = 0.246640727f + p * wc;
  p = 1.50140941f + p * wc;
  T wt = xsqrt(xmax(w, 1e-30f)) - 3.0f;
  T q = T(-0.000200214257f);
  q = 0.000100950558f + q * wt;
  q = 0.00134934322f + q * wt;
  q = -0.00367342844f + q * wt;
  q = 0.00573950773f + q * wt;
  q = -0.0076224613f + q * wt;
  q = 0.00943887047f + q * wt;
  q = 1.00167406f + q * wt;
  q = 2.83297682f + q * wt;
  return (val(w) < 5.0f ? p : q) * x;
}

// cube root of x >= 0 as exp(log(x) / 3) (core/approx.py:cbrt_pos)
__device__ __forceinline__ float cbrt_pos(float x) {
  return expf(logf(fmaxf(x, 1e-30f)) * (1.0f / 3.0f));
}

template <class T>
__device__ T acos_as(const T& x) {
  T ax = xclamp(xabs(x), 0.0f, 1.0f);
  T p = xsqrt(1.0f - ax)
        * (1.5707288f + ax * (-0.2121144f
                              + ax * (0.0742610f - 0.0187293f * ax)));
  return val(x) >= 0.0f ? p : kPi - p;
}

// ---- shading-frame trig (core/frame.py) ---------------------------------
template <class T>
__device__ __forceinline__ T sin2_theta(const V3T<T>& w) {
  return xmax(1.0f - w.z * w.z, 0.0f);
}
template <class T>
__device__ __forceinline__ T sin_theta(const V3T<T>& w) {
  return xsqrt(sin2_theta(w));
}
template <class T>
__device__ __forceinline__ T tan_theta(const V3T<T>& w) {
  const T c = w.z;
  const float cv = val(c);
  T safe = fabsf(cv) < 1e-8f ? T(signf(cv) * 1e-8f + 1e-20f) : c;
  return sin_theta(w) / safe;
}
template <class T>
__device__ __forceinline__ T tan2_theta(const V3T<T>& w) {
  return sin2_theta(w) / xmax(w.z * w.z, 1e-20f);
}
template <class T>
__device__ __forceinline__ T cos_phi(const V3T<T>& w) {
  T st = sin_theta(w);
  return val(st) == 0.0f ? T(1.0f)
                         : xclamp(w.x / xmax(st, 1e-20f), -1.0f, 1.0f);
}
template <class T>
__device__ __forceinline__ T sin_phi(const V3T<T>& w) {
  T st = sin_theta(w);
  return val(st) == 0.0f ? T(0.0f)
                         : xclamp(w.y / xmax(st, 1e-20f), -1.0f, 1.0f);
}

// ---- Beckmann microfacet (materials/microfacet.py) ----------------------
template <class T>
__device__ T beckmann_d(const V3T<T>& wh, const T& ax, const T& ay) {
  T tan2 = xmin(tan2_theta(wh), 1e8f);
  T cos2 = wh.z * wh.z;
  T cos4 = cos2 * cos2;
  T cp = cos_phi(wh), sp = sin_phi(wh);
  T e = xexp(-tan2 * (cp * cp / (ax * ax) + sp * sp / (ay * ay)));
  T dd = e / (kPi * ax * ay * xmax(cos4, 1e-16f));
  return val(tan2) < 1e8f ? dd : T(0.0f);
}

template <class T>
__device__ T beckmann_lambda(const V3T<T>& w, const T& ax, const T& ay) {
  T abs_tan = xmin(xabs(tan_theta(w)), 1e8f);
  T cp = cos_phi(w), sp = sin_phi(w);
  T alpha = xsqrt(cp * cp * ax * ax + sp * sp * ay * ay);
  T a = 1.0f / xmax(alpha * abs_tan, 1e-16f);
  T as = xclamp(a, 1e-4f, 1.6f);
  T lam = (1.0f - 1.259f * as + 0.396f * as * as)
          / (3.535f * as + 2.181f * as * as);
  return val(a) > 1.6f ? T(0.0f) : lam;
}

// BeckmannSample11 (microfacet_distribution.h:34-107): a lane stops once
// |value| < 1e-5, as the reference breaks out of its loop. The tangents
// are those of the unrolled iteration, as jax.vjp takes them. kBuggyErf
// (parity) bounds the bisection with the reference's broken Erf.
template <bool kBuggyErf = false, class T>
__device__ void beckmann_sample11(const T& cos_theta_i, float u1, float u2,
                                  T& slope_x, T& slope_y) {
  if (val(cos_theta_i) > 0.9999f) {
    float r = sqrtf(-log1pf(-fminf(u1, 0.9999999f)));
    float phi = kTwoPi * u2;
    slope_x = T(r * cosf(phi));
    slope_y = T(r * sinf(phi));
    return;
  }
  T cos_t = xclamp(cos_theta_i, -1.0f, 1.0f);
  T sin_t = xsqrt(xmax(1.0f - cos_t * cos_t, 0.0f));
  T tan_t = sin_t / xmax(cos_t, 1e-20f);
  T cot_t = 1.0f / xmax(tan_t, 1e-20f);
  T a = T(-1.0f);
  T c = kBuggyErf ? erf_reference_buggy(cos_t) : erf_as(cos_t);
  float sample_x = fmaxf(u1, 1e-6f);
  T theta_i = acos_as(xclamp(cos_t, -0.999999f, 0.999999f));
  T fit = 1.0f + theta_i * (-0.876f + theta_i * (0.4265f - 0.0594f
                                                 * theta_i));
  T b = c - (1.0f + c) * xexp(fit * logf(fmaxf(1.0f - sample_x, 1e-30f)));
  T normalization = 1.0f / (1.0f + c + kSqrtPiInv * tan_t
                            * xexp(-cot_t * cot_t));
  for (int it = 0; it < 9; ++it) {
    if (!(val(b) >= val(a) && val(b) <= val(c))) b = 0.5f * (a + c);
    T inv_erf = erfinv_giles(b);
    T value = normalization
              * (1.0f + b + kSqrtPiInv * tan_t
                 * xexp(-inv_erf * inv_erf)) - sample_x;
    if (fabsf(val(value)) < 1e-5f) break;
    T derivative = normalization * (1.0f - inv_erf * tan_t);
    if (val(value) > 0.0f) c = b;
    else a = b;
    const float dv = val(derivative);
    T den = fabsf(dv) < 1e-20f ? T(signf(dv) * 1e-20f + 1e-30f) : derivative;
    b = b - value / den;
  }
  slope_x = erfinv_giles(b);
  slope_y = erfinv_giles(T(2.0f * fmaxf(u2, 1e-6f) - 1.0f));
}

template <bool kBuggyErf = false, class T>
__device__ V3T<T> sample_wh_visible(const V3T<T>& wo, const T& ax,
                                    const T& ay, float u1, float u2) {
  bool flip = val(wo.z) < 0.0f;
  V3T<T> wi = flip ? neg(wo) : wo;
  V3T<T> st = v3<T>(ax * wi.x, ay * wi.y, wi.z);
  // divide, not multiply by the reciprocal: one ulp here flips the
  // cosThetaI > 0.9999 normal-incidence branch
  st = divide(st, xmax(xsqrt(dot(st, st)), 1e-20f));
  T sx, sy;
  beckmann_sample11<kBuggyErf>(st.z, u1, u2, sx, sy);
  T cp = cos_phi(st), sp = sin_phi(st);
  T tmp = cp * sx - sp * sy;
  sy = sp * sx + cp * sy;
  sx = ax * tmp;
  sy = ay * sy;
  V3T<T> wh = v3<T>(-sx, -sy, T(1.0f));
  wh = divide(wh, xmax(xsqrt(dot(wh, wh)), 1e-20f));
  return flip ? neg(wh) : wh;
}

template <class T>
__device__ T oren_nayar_term(const V3T<T>& wi, const V3T<T>& wo, const T& a,
                             const T& b) {
  T sin_ti = sin_theta(wi), sin_to = sin_theta(wo);
  T d_cos = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo);
  T max_cos = (val(sin_ti) > 1e-4f && val(sin_to) > 1e-4f)
                  ? xmax(d_cos, 0.0f) : T(0.0f);
  T abs_ci = xabs(wi.z), abs_co = xabs(wo.z);
  bool i_bigger = val(abs_ci) > val(abs_co);
  T sin_alpha = i_bigger ? sin_to : sin_ti;
  T tan_beta = i_bigger ? sin_ti / xmax(abs_ci, 1e-8f)
                        : sin_to / xmax(abs_co, 1e-8f);
  T cos_i = xmax(wi.z, 0.0f);
  return cos_i * (a + b * max_cos * sin_alpha * tan_beta) * kInvPi;
}

// Stage the (S, 12) sphere table as the sweep reads it, three float4s a
// sphere (the layout is set out at the sphere test below); ``dst`` is
// 16-byte aligned.
constexpr int kSphWords = 3;   // float4s a staged sphere

__device__ __forceinline__ void stage_spheres(float4* dst, const float* src,
                                              int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* r = src + 12 * k;
    const float rr = r[8] * r[8];
    dst[kSphWords * k] = make_float4(r[0], r[1], r[2],
                                     r[11] > 0.0f ? -rr : rr);
    dst[kSphWords * k + 1] = make_float4(r[3], r[4], r[5], r[6]);
    dst[kSphWords * k + 2] = make_float4(r[7], r[8], r[9], r[10]);
  }
}

// ---- the scene a bounce reads -----------------------------------------
// Tables entries-major (kernels/bounce.py:build_tables): spheres (S, 12),
// rects (R, 10), materials (M, 14), lights (L, 8) -- staged in shared
// memory by each kernel -- and the image tables in global memory. The
// rich instantiation also reads the media (n_med, 10) and the lights'
// kinds (L,) from global memory and the Perlin tables, gradients (256, 3)
// and permutations (3, 256), from shared memory (stage_rich).
struct SceneView {
  const float4* sph;       // staged sphere records (stage_spheres)
  const float* rect;
  const float* mat;
  const float* light;
  const int* tex_img;    // (n_tex, 3) atlas offset, nx, ny
  const int* atlas_u32;  // packed rgb8
  int n_sph, n_rect, n_mat, n_light, n_atlas;
  int max_depth, rr_start;
  float pdf_floor;
  const float* med;        // kRich
  const int* light_kind;   // kRich: 0 rect, 1 sphere
  const float* pvec;       // kRich, scenes with noise textures
  const int* pperm;
  int n_med;
};

// Stage the scene tables in shared memory (``smem`` holds
// smem_floats(...) floats); the caller synchronises the block after.
__device__ __forceinline__ void stage_tables(SceneView& s, float* smem,
                                             const float* sph,
                                             const float* rect,
                                             const float* mat,
                                             const float* light) {
  float4* s_sph = reinterpret_cast<float4*>(smem);
  float* s_rect = smem + 12 * s.n_sph;
  float* s_mat = s_rect + 10 * s.n_rect;
  float* s_light = s_mat + 14 * s.n_mat;
  stage_spheres(s_sph, sph, s.n_sph);
  for (int k = threadIdx.x; k < 10 * s.n_rect; k += blockDim.x)
    s_rect[k] = rect[k];
  for (int k = threadIdx.x; k < 14 * s.n_mat; k += blockDim.x)
    s_mat[k] = mat[k];
  for (int k = threadIdx.x; k < 8 * s.n_light; k += blockDim.x)
    s_light[k] = light[k];
  s.sph = s_sph;
  s.rect = s_rect;
  s.mat = s_mat;
  s.light = s_light;
}

// The SceneView of a kernel's argument struct, its tables staged in
// ``smem``; the caller synchronises the block before reading them.
template <class Args>
__device__ __forceinline__ SceneView scene_view(const Args& a, float* smem) {
  SceneView s;
  s.tex_img = a.tex_img;
  s.atlas_u32 = a.atlas_u32;
  s.n_sph = a.n_sph;
  s.n_rect = a.n_rect;
  s.n_mat = a.n_mat;
  s.n_light = a.n_light;
  s.n_atlas = a.n_atlas;
  s.max_depth = a.max_depth;
  s.rr_start = a.rr_start;
  s.pdf_floor = a.pdf_floor;
  stage_tables(s, smem, a.sph, a.rect, a.mat, a.light);
  return s;
}

inline size_t smem_bytes(int n_sph, int n_rect, int n_mat, int n_light) {
  return sizeof(float) * (size_t)(12 * n_sph + 10 * n_rect + 14 * n_mat
                                  + 8 * n_light);
}

// The rich instantiation's part of the scene: the media and the lights'
// kinds in global memory, and, when ``a.perlin`` is set, the Perlin
// tables copied into ``smem`` after the tables stage_tables put there
// (rich_smem_bytes more); the caller synchronises the block after.
template <class Args>
__device__ __forceinline__ void stage_rich(SceneView& s, float* smem,
                                           const Args& a) {
  s.med = a.med;
  s.n_med = a.n_med;
  s.light_kind = a.light_kind;
  s.pvec = nullptr;
  s.pperm = nullptr;
  if (a.perlin) {
    float* pv = smem + 12 * s.n_sph + 10 * s.n_rect + 14 * s.n_mat
                + 8 * s.n_light;
    int* pp = reinterpret_cast<int*>(pv + 3 * kPerlin);
    for (int k = threadIdx.x; k < 3 * kPerlin; k += blockDim.x) {
      pv[k] = a.perlin_vec[k];
      pp[k] = a.perlin_perm[k];
    }
    s.pvec = pv;
    s.pperm = pp;
  }
}

inline size_t rich_smem_bytes(int perlin) {
  return perlin ? sizeof(float) * 6 * kPerlin : 0;
}

// ---- textures (materials/textures.py, render/intersect.py:sphere_uv) ---
__device__ inline void sphere_uv(V3 unit, float& u, float& v) {
  float x = unit.x, y = unit.y, z = unit.z;
  bool off_axis = x * x + z * z > 1e-12f;
  float phi = atan2f(off_axis ? z : 0.0f, off_axis ? x : 1.0f);
  y = clampf(y, -1.0f, 1.0f);
  bool inner = fabsf(y) < 0.999999f;
  float theta = inner ? asinf(y) : signf(y) * kHalfPi;
  u = 1.0f - (phi + kPi) / kTwoPi;
  v = (theta + kHalfPi) / kPi;
}

__device__ inline V3 image_value(const SceneView& s, int tex, float u,
                                 float v) {
  int off = s.tex_img[3 * tex], nx = s.tex_img[3 * tex + 1];
  int ny = s.tex_img[3 * tex + 2];
  int i = min(max((int)(u * (float)nx), 0), nx - 1);
  int j = min(max((int)((1.0f - v) * (float)ny - 0.001f), 0), ny - 1);
  if (s.n_atlas == 0) return v3(1.0f, 1.0f, 1.0f);
  int base3 = min(max(off / 3 + i + nx * j, 0), s.n_atlas - 1);
  int bits = s.atlas_u32[base3];
  return v3((float)((bits >> 16) & 255) / 255.0f,
            (float)((bits >> 8) & 255) / 255.0f,
            (float)(bits & 255) / 255.0f);
}

// Gradient noise (perlin.h:7-46, textures.py:perlin_noise): the lattice
// cell by floor then int, wrapped by & 255 (two's complement, as numpy
// and XLA wrap negative coordinates); the three permutations xor-combined
// index the gradients; the corner dots blended trilinearly with the
// hermite weights, in the plain version's order. Over T the tangents run
// through the fractions (the floor's tangent is 0).
template <class T>
__device__ inline T perlin_noise(const SceneView& s, const V3T<T>& p) {
  const float fx = floorf(val(p.x)), fy = floorf(val(p.y));
  const float fz = floorf(val(p.z));
  const T ux = p.x - fx, uy = p.y - fy, uz = p.z - fz;
  const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
  const T sx = ux * ux * (3.0f - 2.0f * ux);
  const T sy = uy * uy * (3.0f - 2.0f * uy);
  const T sz = uz * uz * (3.0f - 2.0f * uz);
  const int hx[2] = {s.pperm[ix & 255], s.pperm[(ix + 1) & 255]};
  const int hy[2] = {s.pperm[kPerlin + (iy & 255)],
                     s.pperm[kPerlin + ((iy + 1) & 255)]};
  const int hz[2] = {s.pperm[2 * kPerlin + (iz & 255)],
                     s.pperm[2 * kPerlin + ((iz + 1) & 255)]};
  T acc = T(0.0f);
#pragma unroll
  for (int di = 0; di < 2; ++di)
#pragma unroll
    for (int dj = 0; dj < 2; ++dj)
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const float* g = s.pvec + 3 * (hx[di] ^ hy[dj] ^ hz[dk]);
        const T corner = g[0] * (ux - (float)di) + g[1] * (uy - (float)dj)
                         + g[2] * (uz - (float)dk);
        const T wx = di ? sx : 1.0f - sx;
        const T wy = dj ? sy : 1.0f - sy;
        const T wz = dk ? sz : 1.0f - sz;
        acc = acc + wx * wy * wz * corner;
      }
  return acc;
}

// Marble, 0.5 (1 + sin(scale z + 5 turb(scale p))) (texture.h:42), with
// kOctaves octaves of turbulence (perlin.h:48-58).
template <class T>
__device__ inline T marble(const SceneView& s, float scl, const V3T<T>& p) {
  V3T<T> q = scale(p, scl);
  T acc = T(0.0f);
  float w = 1.0f;
#pragma unroll 1
  for (int o = 0; o < kOctaves; ++o) {
    acc = acc + w * perlin_noise(s, q);
    w *= 0.5f;
    q = scale(q, 2.0f);
  }
  return 0.5f * (1.0f + xsin(scl * p.z + 5.0f * xabs(acc)));
}

// ---- closest hit (float) ---------------------------------------------------
struct Winner {
  float t;        // kBig on a miss
  float u, v;     // rect or triangle uv (spheres: from the unit vector)
  int sph, rect;  // the winner's index, -1 for the other kinds
  int tri;        // the external (triangle) winner's index, -1 otherwise
  V3 n;           // the triangle winner's shading normal
  int m;          // material id, 0 on a miss
  bool hit;
};

// ---- the sphere records and the sphere test ------------------------------
// A record of the (S, 12) sphere table (kernels/bounce.py:build_tables):
// centre0 xyz, centre1 - centre0 xyz, t0, 1 / max(t1 - t0, 1e-20), radius,
// material, flip sign, env flag. The kernels stage it in shared memory as
// three float4s a sphere, in the order the sweep reads them:
//   [0] centre0 xyz, the radius squared (negated for an env dome),
//   [1] centre1 - centre0 xyz, t0,
//   [2] 1 / max(t1 - t0, 1e-20), radius, material, flip sign,
// so a static sphere's test reads one 16-byte word and a moving one's two
// and a float. The radius squared is the product the test took in its
// loop, taken once at staging (stage_spheres): the same IEEE product,
// the same bits.
__device__ __forceinline__ bool sphere_env(const float4* r) {
  return __float_as_int(r[0].w) < 0;
}
__device__ __forceinline__ float sphere_radius(const float4* r) {
  return r[2].y;
}
__device__ __forceinline__ int sphere_material(const float4* r) {
  return (int)r[2].z;
}
__device__ __forceinline__ float sphere_flip(const float4* r) {
  return r[2].w;
}

// With kMoving the centre at ``time`` (moving_sphere.h:19-21), the lerp
// factor taken with the table's reciprocal as the JAX kernels take it
// (pallas/bounce.py:393-396, pallas/spheres.py:150-154); else centre0.
template <bool kMoving>
__device__ __forceinline__ V3 sphere_center(const float4* r, float time) {
  const float4 c = r[0];
  if constexpr (kMoving) {
    const float4 m = r[1];
    const float f = (time - m.w) * r[2].x;
    return v3(c.x + f * m.x, c.y + f * m.y, c.z + f * m.z);
  } else {
    return v3(c.x, c.y, c.z);
  }
}

// The ray's distance to the staged sphere ``r``: the near root, else the
// far root, beyond t_min; an env dome always at its far root; kBig on a
// miss. The bounce's sweep (sphere_share, closest_hit) and the
// sphere-winner kernel (B6) all call this, so B6's winner is the sphere
// the bounce shades, bit for bit. Where the discriminant is not positive
// both roots are -b (the square root taken as 0), so the test skips the
// square root and the root choice: only an env dome can take -b there.
template <bool kMoving>
__device__ __forceinline__ float sphere_t(const float4* r, V3 o, V3 d,
                                          float time, float t_min) {
  const float4 c0 = r[0];
  const V3 oc = sub(o, sphere_center<kMoving>(r, time));
  const float b = dot(oc, d);
  const float c = dot(oc, oc) - fabsf(c0.w);
  const float disc = b * b - c;
  const bool env = __float_as_int(c0.w) < 0;
  if (!(disc > 0.0f)) return env && -b > t_min ? -b : kBig;
  const float sq = sqrtf(disc);
  const float t0 = -b - sq, t1 = -b + sq;
  if (env) return t1 > t_min ? t1 : kBig;   // env dome: far root
  if (t0 > t_min && t0 < kBig) return t0;
  if (t1 > t_min && t1 < kBig) return t1;
  return kBig;
}

// Spheres, then rects; strict < keeps the lowest index. The one-thread
// sweep: the kernels run its sphere part split over shares (sphere_share,
// nearest_share) and its rect part in finish_hit, which give its winner.
template <bool kMoving = false>
__device__ inline Winner closest_hit(const SceneView& s, V3 o, V3 d,
                                     float time = 0.0f) {
  Winner W;
  float t_best = kBig;
  int w_sph = -1, w_rect = -1;
  float w_u = 0.0f, w_v = 0.0f;
  for (int k = 0; k < s.n_sph; ++k) {
    const float t = sphere_t<kMoving>(s.sph + kSphWords * k, o, d, time,
                                      kTMin);
    if (t < t_best) {
      t_best = t;
      w_sph = k;
    }
  }
  for (int k = 0; k < s.n_rect; ++k) {
    const float* r = s.rect + 10 * k;
    int na = (int)r[0], ua = (int)r[1], va = (int)r[2];
    float d_n = comp(d, na);
    float t = (r[3] - comp(o, na)) / (fabsf(d_n) < 1e-20f ? 1e-20f : d_n);
    float pu = comp(o, ua) + t * comp(d, ua);
    float pv = comp(o, va) + t * comp(d, va);
    bool valid = pu >= r[4] && pu <= r[5] && pv >= r[6] && pv <= r[7]
                 && t > kTMin && t < kBig;
    if (valid && t < t_best) {
      t_best = t;
      w_rect = k;
      w_u = (pu - r[4]) / (r[5] - r[4]);
      w_v = (pv - r[6]) / (r[7] - r[6]);
    }
  }
  W.t = t_best;
  W.u = w_u;
  W.v = w_v;
  W.sph = w_sph;
  W.rect = w_rect;
  W.tri = -1;
  W.n = v3(0.0f, 0.0f, 0.0f);
  W.hit = t_best < kBig;
  W.m = !W.hit ? 0 : (w_rect >= 0 ? (int)s.rect[10 * w_rect + 8]
                                   : sphere_material(s.sph
                                                     + kSphWords * w_sph));
  return W;
}

// ---- the sweep split over a lane's threads ------------------------------
// A lane's sphere sweep may run on G threads, its shares: share p of G
// tests spheres p, p + G, p + 2G, ... and keeps the first of the nearest
// among them (t kBig and index -1 when none is hit). The shares meet in
// nearest_share, the nearest t first and the lowest index on a tie, which
// is the first of the nearest over all spheres, closest_hit's sphere
// winner; finish_hit then runs closest_hit's rect sweep against it. The
// bounces sweep beyond kTMin; the sphere winner (B6) passes its own t_min.
template <bool kMoving>
__device__ __forceinline__ void sphere_share(const SceneView& s, V3 o, V3 d,
                                             float time, int p, int G,
                                             float& t_best, int& k_best,
                                             float t_min = kTMin) {
  t_best = kBig;
  k_best = -1;
#pragma unroll 4
  for (int k = p; k < s.n_sph; k += G) {
    const float t = sphere_t<kMoving>(s.sph + kSphWords * k, o, d, time,
                                      t_min);
    if (t < t_best) {
      t_best = t;
      k_best = k;
    }
  }
}

// Folds a share's (t, k) into (t_best, k_best): the nearer, the lower
// index on a tie
__device__ __forceinline__ void nearest_share(float t, int k, float& t_best,
                                              int& k_best) {
  if (t < t_best || (t == t_best && t < kBig && k < k_best)) {
    t_best = t;
    k_best = k;
  }
}

// closest_hit's winner, given its spheres' winner (t_sph, k_sph): the rect
// sweep alone, whose best wins only when strictly nearer, as closest_hit's
// strict < lets a rect win over the spheres before it
__device__ __forceinline__ Winner finish_hit(SceneView s, V3 o, V3 d,
                                             float t_sph, int k_sph) {
  s.n_sph = 0;
  Winner W = closest_hit(s, o, d);
  W.sph = k_sph;
  if (!(W.hit && W.t < t_sph)) {
    W.t = t_sph;
    W.u = 0.0f;
    W.v = 0.0f;
    W.rect = -1;
    W.hit = t_sph < kBig;
    W.m = W.hit ? sphere_material(s.sph + kSphWords * k_sph) : 0;
  }
  return W;
}

// An external closest hit (a triangle found by a BVH walk, B3 or B4,
// assembled by the caller): t (kBig on a miss), uv, the normalised
// interpolated shading normal, the material and the triangle's index.
struct ExtHit {
  float t, u, v;
  V3 n;
  int m, idx;
};

// The external hit competes after spheres and rects and wins only when
// strictly nearer (srt_tpu/pallas/bounce.py:1256-1266); its lane is then
// shaded like a rect lane with the given normal and uv. W.tri >= 0 marks
// a winner whose normal and uv are given (a triangle, or an in-scatter
// event of take_media).
__device__ __forceinline__ void take_external(Winner& W, const ExtHit& e) {
  if (e.t < W.t) {
    W.t = e.t;
    W.u = e.u;
    W.v = e.v;
    W.n = e.n;
    W.m = e.m;
    W.tri = e.idx;
    W.sph = -1;
    W.rect = -1;
    W.hit = true;
  }
}

// Medium record ``r`` (kind, center xyz, radius, half extents xyz,
// density, material) along the ray: where the ray enters it (``t_in``)
// and leaves it (``t_out``), and whether it crosses it at all. Over T in
// the safe_ad forms of _media_sweep (srt_tpu/pallas/bounce.py:505, :511):
// the sphere's root by sqrt_pos and the slabs' reciprocals by a clamped
// division, the same values as the float forms.
template <class T>
__device__ __forceinline__ bool medium_span(const float* __restrict__ r,
                                            const V3T<T>& o, const V3T<T>& d,
                                            T& t_in, T& t_out) {
  const V3T<T> oc = sub(o, lift3<T>(v3(__ldg(r + 1), __ldg(r + 2),
                                       __ldg(r + 3))));
  if (__ldg(r) == 1.0f) {   // box
    const V3 h = v3(__ldg(r + 5), __ldg(r + 6), __ldg(r + 7));
    const V3T<T> inv = v3<T>(
        1.0f / (fabsf(val(d.x)) < 1e-20f ? T(1e-20f) : d.x),
        1.0f / (fabsf(val(d.y)) < 1e-20f ? T(1e-20f) : d.y),
        1.0f / (fabsf(val(d.z)) < 1e-20f ? T(1e-20f) : d.z));
    const T t0x = (-h.x - oc.x) * inv.x, t1x = (h.x - oc.x) * inv.x;
    const T t0y = (-h.y - oc.y) * inv.y, t1y = (h.y - oc.y) * inv.y;
    const T t0z = (-h.z - oc.z) * inv.z, t1z = (h.z - oc.z) * inv.z;
    t_in = xmax(xmax(xmin(t0x, t1x), xmin(t0y, t1y)), xmin(t0z, t1z));
    t_out = xmin(xmin(xmax(t0x, t1x), xmax(t0y, t1y)), xmax(t0z, t1z));
    return val(t_out) > val(t_in);
  }
  const float rad = __ldg(r + 4);
  const T bq = dot(oc, d);
  const T cq = dot(oc, oc) - rad * rad;
  const T disc = bq * bq - cq;
  const T sq = sqrt_pos(disc);
  t_in = -bq - sq;
  t_out = -bq + sq;
  return val(disc) > 0.0f;
}

// The free flight of medium ``m``: an exponential draw of dimension m of
// the bounce's ``salt``, no tangent.
__device__ __forceinline__ float free_flight(const float* __restrict__ r,
                                             uint32_t salt, int m) {
  const float u = fmaxf(uniform(salt, (uint32_t)m), 1e-12f);
  return -logf(u) / __ldg(r + 8);
}

// Participating media after the surface hit (_media_sweep,
// srt_tpu/pallas/bounce.py:486-542): for each sphere (kind 0) or box
// (kind 1) medium of the (n_med, 10) records, an exponential free flight
// from where the ray enters it; an event nearer than the winner overrides
// it, shaded as the medium's isotropic material with normal +x and uv 0,
// W.tri holding the medium's index. ``salt`` is the bounce's salt; medium
// m draws dimension m.
__device__ inline void take_media(Winner& W, const float* __restrict__ med,
                                  int n_med, V3 o, V3 d, uint32_t salt) {
  for (int m = 0; m < n_med; ++m) {
    const float* r = med + 10 * m;
    float t_in, t_out;
    const bool ok = medium_span(r, o, d, t_in, t_out);
    const float t_enter = fmaxf(t_in, 0.0f);
    const float t_exit = fminf(t_out, W.t);
    const float free = free_flight(r, salt, m);
    const float t_sc = t_enter + free;
    if (ok && t_exit > t_enter && free < t_exit - t_enter && t_sc < W.t) {
      W.t = t_sc;
      W.u = 0.0f;
      W.v = 0.0f;
      W.n = v3(1.0f, 0.0f, 0.0f);
      W.m = (int)__ldg(r + 9);
      W.tri = m;
      W.sph = -1;
      W.rect = -1;
      W.hit = true;
    }
  }
}

// The specular branch of a lane on a metal, dielectric or isotropic
// material (srt_tpu/pallas/bounce.py:663-729): the new direction and the
// attenuation. ``n`` is the stored normal, ``p0`` the material's first
// parameter (fuzz, refractive index), ``alb`` its colour; uniforms of
// dimensions 8-11 of the bounce's salt. Schlick's reflectance only picks
// the branch, so it is taken on the values.
template <class T>
__device__ inline void scatter_specular(int m_type, const T& p0,
                                        const V3T<T>& alb, const V3T<T>& n,
                                        const V3T<T>& d, uint32_t salt,
                                        V3T<T>& dir, V3T<T>& att) {
  const T ddn = dot(d, n);
  const V3T<T> refl = sub(d, scale(n, 2.0f * ddn));
  if (m_type == kDielectric) {
    const T ref_idx = xmax(p0, 1e-2f);
    const bool going_out = val(ddn) > 0.0f;
    const V3T<T> out_n = going_out ? neg(n) : n;
    const T ni = going_out ? ref_idx : 1.0f / ref_idx;
    const float cosine = going_out ? val(ddn) : -val(ddn);
    const T dt = dot(d, out_n);
    const T disc = 1.0f - ni * ni * (1.0f - dt * dt);
    const T sq = sqrt_pos(disc);
    const V3T<T> refr = sub(scale(sub(d, scale(out_n, dt)), ni),
                            scale(out_n, sq));
    const float fi = val(ref_idx);
    float r0 = (1.0f - fi) / (1.0f + fi);
    r0 = r0 * r0;
    const float omc = fmaxf(1.0f - cosine, 0.0f);
    const float omc2 = omc * omc;
    const float schlick = r0 + (1.0f - r0) * omc2 * omc2 * omc;
    const float reflect_prob = val(disc) > 0.0f ? schlick : 1.0f;
    dir = normalize(uniform(salt, 11) < reflect_prob ? refl : refr);
    att = v3<T>(T(1.0f), T(1.0f), T(1.0f));
    return;
  }
  const float z = 1.0f - 2.0f * uniform(salt, 8);
  const float phi = kTwoPi * uniform(salt, 9);
  const float r_xy = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  if (m_type == kMetal) {
    const float radius = cbrt_pos(fmaxf(uniform(salt, 10), 1e-12f));
    const V3 ball = v3(radius * r_xy * cosf(phi), radius * r_xy * sinf(phi),
                       radius * z);
    dir = safe_normalize_rcp(add(refl, v3<T>(ball.x * p0, ball.y * p0,
                                             ball.z * p0)));
  } else {   // isotropic: a uniform direction
    dir = lift3<T>(normalize(v3(r_xy * cosf(phi), r_xy * sinf(phi), z)));
  }
  att = alb;
}

// The colour of material record ``mt``'s texture at the hit (the rich
// instantiation; texture_value, srt_tpu_torch/materials/textures.py):
// the constant colour ``mc``, the checker's (the sign of three sines at p,
// texture.h:13-19; ``mc2`` the odd colour), marble (column 12 holds the
// noise scale) or the image at the rect's or triangle's uv, or at the
// sphere's from its unit vector ``unit``. ``mc`` and ``mc2`` are columns
// 6-8 and 9-11 of ``mt``, with tangents in B5.
template <class T>
__device__ inline V3T<T> texture_at(const SceneView& s, const float* mt,
                                    const Winner& W, V3 unit,
                                    const V3T<T>& p, const V3T<T>& mc,
                                    const V3T<T>& mc2) {
  const int tt = (int)mt[5];
  if (tt == kTexChecker) {
    const float sines = sinf(10.0f * val(p.x)) * sinf(10.0f * val(p.y))
                        * sinf(10.0f * val(p.z));
    return sines < 0.0f ? mc2 : mc;
  }
  if (tt == kTexNoise) {
    const T m = marble(s, mt[12], p);
    return v3<T>(m, m, m);
  }
  if (tt == kTexImage) {
    float u = W.u, v = W.v;
    if (W.rect < 0 && W.tri < 0) sphere_uv(unit, u, v);
    return lift3<T>(image_value(s, (int)mt[13], u, v));
  }
  return mc;
}

// Sphere lights (render/lights.py:_sphere_sample, _sphere_pdf;
// sphere.h:7-15, 69-86). ``l`` is the light's row: centre xyz, radius.
// From inside the sphere every direction hits it: a uniform direction,
// pdf 1/4pi; the cone's cos_max, negative there, takes sqrt_pos's zero
// tangent.
template <class T>
__device__ inline V3T<T> sphere_light_dir(const float* l, const V3T<T>& p,
                                          float u1, float u2) {
  const V3T<T> to_c = sub(lift3<T>(v3(l[0], l[1], l[2])), p);
  const float rad = l[3];
  const T dist_sq = dot(to_c, to_c);
  const bool inside = val(dist_sq) <= rad * rad;
  const T cmx = sqrt_pos(1.0f - rad * rad / xmax(dist_sq, 1e-12f));
  const T z = inside ? T(1.0f - 2.0f * u2) : 1.0f + u2 * (cmx - 1.0f);
  const float phi = kTwoPi * u1;
  const T sq = sqrt_pos(1.0f - z * z);
  const V3T<T> lw = normalize(to_c);
  const V3T<T> la = lift3<T>(fabsf(val(lw.x)) > 0.9f ? v3(0.0f, 1.0f, 0.0f)
                                                     : v3(1.0f, 0.0f, 0.0f));
  const V3T<T> lv = normalize(cross(lw, la));
  const V3T<T> lu = cross(lw, lv);
  return add(add(scale(lu, cosf(phi) * sq), scale(lv, sinf(phi) * sq)),
             scale(lw, z));
}

template <class T>
__device__ inline T sphere_light_pdf(const float* l, const V3T<T>& p,
                                     const V3T<T>& wi) {
  const V3T<T> oc = sub(p, lift3<T>(v3(l[0], l[1], l[2])));
  const float rad = l[3];
  const T b = dot(oc, wi);
  const T c = dot(oc, oc) - rad * rad;
  const T disc = b * b - c;
  const T sqd = sqrt_pos(disc);
  const bool hits = val(disc) > 0.0f && (val(-b - sqd) > 1e-3f
                                         || val(-b + sqd) > 1e-3f);
  const T cmx = sqrt_pos(1.0f - rad * rad / xmax(c + rad * rad, 1e-12f));
  const T solid = kTwoPi * (1.0f - cmx);
  const T pdf = hits ? 1.0f / xmax(solid, 1e-12f) : T(0.0f);
  return val(c) <= 0.0f ? T(kInv4Pi) : pdf;
}

// The lights' solid-angle pdfs at wi from p, summed (lights.py:
// lights_pdf before its division by the count): a rect light's where wi
// crosses it beyond 1e-3, with kRich a sphere light's
template <bool kRich, class T>
__device__ __forceinline__ T light_pdf_sum(const SceneView& s,
                                           const V3T<T>& p,
                                           const V3T<T>& wi) {
  T lpdf = T(0.0f);
  for (int k = 0; k < s.n_light; ++k) {
    const float* l = s.light + 8 * k;
    if constexpr (kRich) {
      if (__ldg(s.light_kind + k) == kLightSphere) {
        lpdf = lpdf + sphere_light_pdf(l, p, wi);
        continue;
      }
    }
    int na = (int)l[0], ua = (int)l[1], va = (int)l[2];
    T d_n = comp(wi, na);
    T t = (l[3] - comp(p, na))
          / (fabsf(val(d_n)) < 1e-12f ? T(1e-12f) : d_n);
    T hu = comp(p, ua) + t * comp(wi, ua);
    T hv = comp(p, va) + t * comp(wi, va);
    bool inside = val(t) > 1e-3f && val(hu) >= l[4] && val(hu) <= l[5]
                  && val(hv) >= l[6] && val(hv) <= l[7];
    float area = (l[5] - l[4]) * (l[7] - l[6]);
    T pl = t * t / xmax(xabs(d_n) * area, 1e-12f);
    lpdf = lpdf + (inside ? pl : T(0.0f));
  }
  return lpdf;
}

// The winner's t: the sweep's value in the forward; in the backward the
// same formulas recomputed from (o, d), the same value bit for bit, with
// tangents (bounce_bwd.py:155-177). With kRich a winner with W.tri >= 0
// is a medium event (B5 takes no external hit): its t is where the ray
// enters medium W.tri plus the free flight (the safe_ad twin of
// _media_sweep, bounce_bwd.py:179-182).
template <bool kRich>
__device__ __forceinline__ float hit_t(const SceneView&, const Winner& W,
                                       const V3&, const V3&, uint32_t) {
  return W.t;
}
template <bool kRich, int K>
__device__ Dual<K> hit_t(const SceneView& s, const Winner& W,
                         const V3T<Dual<K>>& o, const V3T<Dual<K>>& d,
                         uint32_t salt) {
  using D = Dual<K>;
  if (kRich && W.tri >= 0) {
    const float* r = s.med + 10 * W.tri;
    D t_in, t_out;
    medium_span(r, o, d, t_in, t_out);
    // max(t_in, 0) as jnp.maximum differentiates it: half the tangent on
    // a tie (a ray that starts on the medium's face)
    const D t_enter = t_in.v > 0.0f ? t_in
                      : (t_in.v == 0.0f ? 0.5f * t_in : D(0.0f));
    return t_enter + free_flight(r, salt, W.tri);
  }
  if (W.rect >= 0) {
    const float* r = s.rect + 10 * W.rect;
    const int na = (int)r[0];
    D d_n = comp(d, na);
    return (r[3] - comp(o, na)) / (fabsf(d_n.v) < 1e-20f ? D(1e-20f) : d_n);
  }
  const float4* r = s.sph + kSphWords * W.sph;
  V3T<D> oc = sub(o, lift3<D>(sphere_center<false>(r, 0.0f)));
  D b = dot(oc, d);
  D c = dot(oc, oc) - fabsf(r[0].w);
  D disc = b * b - c;
  D sq = disc.v > 0.0f ? xsqrt(disc) : D(0.0f);
  D t0 = -b - sq, t1 = -b + sq;
  if (sphere_env(r)) return t1;          // env dome: the far root
  return (disc.v > 0.0f && t0.v > kTMin && t0.v < kBig) ? t0 : t1;
}

// ---- the shading of one live lane ---------------------------------------
template <class T>
struct LaneT {
  V3T<T> o, d, beta, rad;
};

// Everything after the closest hit: emission (the env dome's image
// texture looked up here, where the JAX package defers it to an XLA
// epilogue), then the diffuse branch -- Beckmann VNDF or cosine-lobe
// BSDF sample mixed 50/50 with a light sample, the mixture pdf, the
// BSDF weight, roulette. ``salt`` is the bounce's salt (the lane's salt
// combined with its depth); ``mp0, mp1`` are the material's parameters 0
// and 1, ``mc`` its constant colour and ``mc2`` its second (the checker's
// odd) colour. Returns alive-after-bounce (before the depth cap) and
// updates L. Emitter and miss lanes keep o, d, beta.
// kExt: the winner may be an external (triangle) hit. kRich: the winner
// may be a medium event, the albedo and the emission are the
// material's texture at the hit (texture_at), specular lanes take the
// specular branch, and a light row may be a sphere (light_kind); the
// albedo multiplies the throughput before roulette, as the plain version
// does. kMoving: a sphere winner's centre is its centre at the lane's
// ``time``.
template <class T>
__device__ __forceinline__ bool scatter_to(const SceneView& s, uint32_t salt,
                                           int depth, const V3T<T>& p,
                                           const V3T<T>& wi, V3T<T> nb,
                                           LaneT<T>& L) {
  T beta_max = xmax(xmax(nb.x, nb.y), nb.z);
  bool alive = val(beta_max) > 0.0f;
  if (s.rr_start < s.max_depth && depth >= s.rr_start) {
    T q = xclamp(beta_max, 0.05f, 1.0f);
    alive = alive && uniform(salt, 16) < val(q);
    if (alive) nb = divide(nb, q);
  }
  L.o = p;
  L.d = wi;
  L.beta = nb;
  return alive;
}

// ---- the reference-parity estimator (kParity, B2's float shade) -------
// integrator.py:parity_draw and the parity forms of materials.py
constexpr int kDimRetry = 17;        // resample rounds, 4 dimensions each
constexpr int kDimSlot = 33;         // the heap slot's Bernoulli
constexpr int kParityRetries = 4;
constexpr float kParitySlotZeroP = 0.086f;
constexpr float kParityKill = 1e30f;

// The heap slot at the start of a bounce (integrator.py:parity_slot):
// 0 with probability kParitySlotZeroP, else kParityKill; 0 under
// parity_no_stale. ``salt`` is the bounce's salt.
__device__ __forceinline__ float parity_slot(uint32_t salt, int no_stale) {
  if (no_stale) return 0.0f;
  return uniform(salt, kDimSlot) < kParitySlotZeroP ? 0.0f : kParityKill;
}

// A light sample's direction: the picked rect light's uniform point, or
// with kRich the cone toward a sphere light (lights.py:sample_lights)
template <bool kRich>
__device__ __forceinline__ V3 light_dir(const SceneView& s, const V3& p,
                                        float u_pick, float u1, float u2) {
  const int pick = min((int)(u_pick * (float)s.n_light), s.n_light - 1);
  const float* l = s.light + 8 * pick;
  if constexpr (kRich) {
    if (__ldg(s.light_kind + pick) == kLightSphere)
      return sphere_light_dir(l, p, u1, u2);
  }
  V3 point;
  set_comp(point, (int)l[0], l[3]);
  set_comp(point, (int)l[1], l[4] + u1 * (l[5] - l[4]));
  set_comp(point, (int)l[2], l[6] + u2 * (l[7] - l[6]));
  return normalize(sub(point, p));
}

// A shading frame: the face frame (bu, bv, nw) about the viewer-side
// normal, or the raw frame about the stored normal; wo is -d in it
struct Frame {
  V3 u, v, w, wo;
};

// The BSDF pdf under parity at the world direction ``wi`` (materials.py:
// bsdf_pdf): Beckmann's stored D(wh) G(d_world, wi) / (4|cosI||cosO|) in
// the raw frame ``r``, zeroed off its hemisphere; Oren-Nayar's full term
// and the cosine lobe's cos/pi in the face frame ``f``.
__device__ inline float parity_pdf(int m_type, float mp0, float mp1, float ax,
                            float ay, const V3& wi, const V3& d,
                            const Frame& f, const Frame& r) {
  if (m_type == kBeckmann) {
    const V3 wr = v3(dot(wi, r.u), dot(wi, r.v), dot(wi, r.w));
    const V3 wh = safe_normalize(add(wr, r.wo));
    const float g = 1.0f / (1.0f + beckmann_lambda(d, ax, ay)
                            + beckmann_lambda(wr, ax, ay));
    const float beck = beckmann_d(wh, ax, ay) * g
                       / fmaxf(4.0f * fabsf(wr.z) * fabsf(r.wo.z), 1e-8f);
    return r.wo.z * wr.z > 0.0f ? beck : 0.0f;
  }
  const V3 wl = v3(dot(wi, f.u), dot(wi, f.v), dot(wi, f.w));
  if (m_type == kOrenNayar) return oren_nayar_term(wl, f.wo, mp0, mp1);
  return fmaxf(wl.z, 0.0f) * kInvPi;
}

// The diffuse branch of a lane under parity (integrator.py:parity_draw,
// srt_tpu/pallas/bounce.py:930-1030): up to 1 + kParityRetries rounds
// on fresh dimensions while the mixture pdf is not positive, a lane that
// drew a positive pdf skipping the rest. Lambertian and Oren-Nayar lanes
// always take the light; a Beckmann lane that takes the light reads
// ``slot`` as its BSDF pdf, and one that takes its VNDF sample (the raw
// frame, the broken Erf) stores that sample's pdf there, the one pdf a
// round evaluates. Then the as-implemented weight (cos/pi on the diffuse
// lobes, D G1(wo) / (4|cosO|) on Beckmann, no hemisphere clamp), the
// throughput update and roulette as shade's.
template <bool kRich>
__device__ bool diffuse_parity(const SceneView& s, uint32_t salt, int depth,
                               int m_type, float mp0, float mp1, float ax,
                               float ay, const V3& alb, const V3& normal,
                               const V3& p, const V3& d, const Frame& f,
                               float& slot, LaneT<float>& L) {
  const bool is_beck = m_type == kBeckmann;
  const bool light_only = m_type == kLambertian || m_type == kOrenNayar;
  Frame r;
  r.w = normalize(normal);
  r.v = normalize(cross(r.w, fabsf(r.w.x) > 0.9f ? v3(0.0f, 1.0f, 0.0f)
                                                 : v3(1.0f, 0.0f, 0.0f)));
  r.u = cross(r.w, r.v);
  const V3 md = neg(d);
  r.wo = normalize(v3(dot(md, r.u), dot(md, r.v), dot(md, r.w)));
  V3 wi = v3(0.0f, 0.0f, 1.0f);
  float pdf = 0.0f;
#pragma unroll 1
  for (int rnd = 0; rnd <= kParityRetries; ++rnd) {
    const uint32_t base = kDimRetry + 4 * (rnd - 1);
    const uint32_t dim_mix = rnd ? base : 12u;
    const uint32_t dim_pick = rnd ? base + 1 : 13u;
    const uint32_t dim_s = rnd ? base + 2 : 14u;
    const float u1 = uniform(salt, dim_s), u2 = uniform(salt, dim_s + 1);
    const bool pick_light = s.n_light > 0
                            && (uniform(salt, dim_mix) < 0.5f || light_only);
    float bpdf;
    if (pick_light) {
      wi = light_dir<kRich>(s, p, uniform(salt, dim_pick), u1, u2);
      bpdf = is_beck ? slot
                     : parity_pdf(m_type, mp0, mp1, ax, ay, wi, d, f, r);
    } else {
      if (is_beck) {
        const V3 wh = sample_wh_visible<true>(r.wo, ax, ay, u1, u2);
        const float k2 = 2.0f * dot(r.wo, wh);
        const V3 bw = v3(-r.wo.x + k2 * wh.x, -r.wo.y + k2 * wh.y,
                         -r.wo.z + k2 * wh.z);
        wi = normalize(add(add(scale(r.u, bw.x), scale(r.v, bw.y)),
                           scale(r.w, bw.z)));
      } else {
        const float phi = kTwoPi * u1;
        const float sq = sqrtf(u2);
        const V3 cd = v3(cosf(phi) * sq, sinf(phi) * sq,
                         sqrtf(fmaxf(1.0f - u2, 0.0f)));
        wi = normalize(add(add(scale(f.u, cd.x), scale(f.v, cd.y)),
                           scale(f.w, cd.z)));
      }
      bpdf = parity_pdf(m_type, mp0, mp1, ax, ay, wi, d, f, r);
      if (is_beck && s.n_light > 0) slot = bpdf;   // the draw stores it
    }
    pdf = s.n_light > 0
              ? 0.5f * (light_pdf_sum<kRich>(s, p, wi) / (float)s.n_light)
                    + 0.5f * bpdf
              : bpdf;
    if (!(pdf <= 0.0f)) break;
  }
  float wgt = fmaxf(dot(wi, f.w), 0.0f) * kInvPi;
  if (is_beck) {
    const V3 wr = normalize(v3(dot(wi, r.u), dot(wi, r.v), dot(wi, r.w)));
    const V3 wh = safe_normalize(add(wr, r.wo));
    wgt = beckmann_d(wh, ax, ay) * (1.0f / (1.0f + beckmann_lambda(r.wo, ax,
                                                                   ay)))
          / fmaxf(4.0f * fabsf(r.wo.z), 1e-8f);
  }
  const bool ok = pdf > s.pdf_floor;
  const float den = fmaxf(pdf, s.pdf_floor);
  const V3 nb = v3(L.beta.x * (ok ? alb.x * wgt / den : 0.0f),
                   L.beta.y * (ok ? alb.y * wgt / den : 0.0f),
                   L.beta.z * (ok ? alb.z * wgt / den : 0.0f));
  return scatter_to(s, salt, depth, p, wi, nb, L);
}

template <class T, bool kExt = false, bool kMoving = false,
          bool kRich = false, bool kParity = false>
__device__ __forceinline__ bool shade(const SceneView& s, const Winner& W,
                                      uint32_t salt, int depth, float time,
                                      const T& mp0, const T& mp1,
                                      const V3T<T>& mc, const V3T<T>& mc2,
                                      LaneT<T>& L, float* slot = nullptr) {
  // W.tri >= 0 marks a winner whose normal and uv are given: a triangle
  // (kExt) or an in-scatter event of take_media (kRich)
  constexpr bool kGiven = kExt || kRich;
  const V3T<T> o = L.o, d = L.d;
  const bool hit = W.hit;
  V3T<T> p = o;
  V3T<T> normal = v3<T>(T(0.0f), T(0.0f), T(1.0f));
  V3T<T> unit = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  if (hit) {
    p = add(o, scale(d, xmin(hit_t<kRich>(s, W, o, d, salt), kTPosMax)));
    V3T<T> n_st;
    if (W.rect >= 0) {
      const float* r = s.rect + 10 * W.rect;
      n_st = v3<T>(T(0.0f), T(0.0f), T(0.0f));
      set_comp(n_st, (int)r[0], T(r[9]));
    } else if (kGiven && W.tri >= 0) {
      n_st = lift3<T>(W.n);
    } else {
      const float4* r = s.sph + kSphWords * W.sph;
      unit = divide(sub(p, lift3<T>(sphere_center<kMoving>(r, time))),
                    sphere_radius(r));
      n_st = scale(unit, sphere_flip(r));
    }
    if (val(dot(n_st, n_st)) > 1e-12f) normal = n_st;
  }
  const float* mt = s.mat + 14 * W.m;
  const int m_type = (int)mt[0];
  // the albedo (and an emitter's emission): the constant colour, or with
  // kRich the texture at the hit
  V3T<T> alb = mc;
  if constexpr (kRich) {
    if (hit) alb = texture_at(s, mt, W, val3(unit), p, mc, mc2);
  }

  // emission: one-sided, where the stored normal faces the ray
  if (hit && m_type == kDiffuseLight) {
    if (val(dot(normal, d)) < 0.0f) {
      V3T<T> e = alb;
      if (!kRich && (int)mt[5] == kTexImage) {
        float u = W.u, v = W.v;
        if (W.rect < 0 && !(kGiven && W.tri >= 0))
          sphere_uv(val3(unit), u, v);
        e = lift3<T>(image_value(s, (int)mt[13], u, v));
      }
      L.rad = add(L.rad, v3<T>(L.beta.x * e.x, L.beta.y * e.y,
                               L.beta.z * e.z));
    }
    return false;   // emitters do not scatter
  }
  if (!hit) return false;
  if constexpr (kRich) {
    if (m_type == kMetal || m_type == kDielectric || m_type == kIsotropic) {
      V3T<T> dir, att;
      scatter_specular(m_type, mp0, alb, normal, d, salt, dir, att);
      return scatter_to(s, salt, depth, p, dir,
                        v3<T>(L.beta.x * att.x, L.beta.y * att.y,
                              L.beta.z * att.z), L);
    }
  }

  // face-forward shading basis (onb.h about the viewer-side normal)
  const V3T<T> nw = normalize(val(dot(normal, d)) > 0.0f ? neg(normal)
                                                          : normal);
  const V3T<T> helper = lift3<T>(fabsf(val(nw.x)) > 0.9f
                                     ? v3(0.0f, 1.0f, 0.0f)
                                     : v3(1.0f, 0.0f, 0.0f));
  const V3T<T> bv = normalize(cross(nw, helper));
  const V3T<T> bu = cross(nw, bv);
  const V3T<T> md = neg(d);
  const V3T<T> wo = v3<T>(dot(md, bu), dot(md, bv), dot(md, nw));
  const bool is_beck = m_type == kBeckmann;
  const T ax = val(mp0) > 1e-4f ? mp0 : T(1e-4f);
  const T ay = val(mp1) > 1e-4f ? mp1 : T(1e-4f);
  if constexpr (kParity) {
    return diffuse_parity<kRich>(s, salt, depth, m_type, mp0, mp1, ax, ay,
                                 alb, normal, p, d, Frame{bu, bv, nw, wo},
                                 *slot, L);
  }

  // BSDF sample: Beckmann VNDF or the cosine lobe
  const float u1 = uniform(salt, 14), u2 = uniform(salt, 15);
  V3T<T> wi;
  if (is_beck) {
    V3T<T> wh = sample_wh_visible(wo, ax, ay, u1, u2);
    T k2 = 2.0f * dot(wo, wh);
    V3T<T> bw = v3<T>(-wo.x + k2 * wh.x, -wo.y + k2 * wh.y,
                      -wo.z + k2 * wh.z);
    wi = normalize(add(add(scale(bu, bw.x), scale(bv, bw.y)),
                       scale(nw, bw.z)));
  } else {
    float phi = kTwoPi * u1;
    float sq = sqrtf(u2);
    V3 cd = v3(cosf(phi) * sq, sinf(phi) * sq, sqrtf(fmaxf(1.0f - u2, 0.0f)));
    wi = normalize(add(add(scale(bu, cd.x), scale(bv, cd.y)),
                       scale(nw, cd.z)));
  }
  // light sample: a uniform point on the picked rect light, or with
  // kRich a cone toward a sphere light
  if (s.n_light > 0) {
    int pick = min((int)(uniform(salt, 13) * (float)s.n_light),
                   s.n_light - 1);
    const float* l = s.light + 8 * pick;
    bool sphere_light = false;
    if constexpr (kRich) sphere_light = __ldg(s.light_kind + pick)
                                        == kLightSphere;
    if (sphere_light) {
      if constexpr (kRich) {
        const V3T<T> wl = sphere_light_dir(l, p, u1, u2);
        if (uniform(salt, 12) < 0.5f) wi = wl;
      }
    } else {
      V3 point;
      set_comp(point, (int)l[0], l[3]);
      set_comp(point, (int)l[1], l[4] + u1 * (l[5] - l[4]));
      set_comp(point, (int)l[2], l[6] + u2 * (l[7] - l[6]));
      if (uniform(salt, 12) < 0.5f) wi = normalize(sub(lift3<T>(point), p));
    }
  }

  // BSDF pdf and weight at wi (shared half vector)
  const V3T<T> wil = v3<T>(dot(wi, bu), dot(wi, bv), dot(wi, nw));
  const T cos_i = xmax(wil.z, 0.0f);
  T bpdf = cos_i * kInvPi;
  T wgt = cos_i * kInvPi;
  if (m_type == kOrenNayar) wgt = oren_nayar_term(wil, wo, mp0, mp1);
  if (is_beck) {
    bool same = val(wo.z) * val(wil.z) > 0.0f;
    V3T<T> wh = safe_normalize(add(wil, wo));
    T dd = beckmann_d(wh, ax, ay);
    T lam_o = beckmann_lambda(wo, ax, ay);
    T lam_i = beckmann_lambda(wil, ax, ay);
    T g1 = 1.0f / (1.0f + lam_o);
    T vndf = dd * g1 * xabs(dot(wo, wh)) / xmax(xabs(wo.z), 1e-8f);
    bpdf = same ? vndf / xmax(4.0f * xabs(dot(wo, wh)), 1e-8f) : T(0.0f);
    T g = 1.0f / (1.0f + lam_o + lam_i);
    wgt = same ? dd * g / xmax(4.0f * xabs(wo.z), 1e-8f) : T(0.0f);
  }
  T pdf = bpdf;
  if (s.n_light > 0)
    pdf = 0.5f * (light_pdf_sum<kRich>(s, p, wi) / (float)s.n_light)
          + 0.5f * bpdf;

  // throughput update: the albedo times the BSDF weight over the pdf
  const bool ok = val(pdf) > s.pdf_floor;
  const T den = xmax(pdf, s.pdf_floor);
  const V3T<T> nb = v3<T>(L.beta.x * (ok ? alb.x * wgt / den : T(0.0f)),
                          L.beta.y * (ok ? alb.y * wgt / den : T(0.0f)),
                          L.beta.z * (ok ? alb.z * wgt / den : T(0.0f)));
  return scatter_to(s, salt, depth, p, wi, nb, L);
}

// The forward bounce of one live lane (B1, B2) at ray time ``time``, given
// its spheres' winner (t_sph, k_sph) from sphere_share and nearest_share:
// returns alive-after-bounce (before the depth cap) and updates L. With
// kExt (B2's external-hit mode) the external hit ``e`` takes part in the
// closest hit; with kRich the media sweep follows (take_media) and the
// rich shading runs; the lean instantiation is the bounce ball_scenes' B1
// compiles. kMoving: spheres at their centres at ``time``
// (sphere_center). kParity (B2): the parity estimator, which updates the
// heap ``slot`` on lanes that take the diffuse branch.
template <bool kExt = false, bool kMoving = false, bool kRich = false,
          bool kParity = false>
__device__ __forceinline__ bool bounce(const SceneView& s, uint32_t salt,
                                       int depth, float time, LaneT<float>& L,
                                       float t_sph, int k_sph,
                                       const ExtHit* e = nullptr,
                                       float* slot = nullptr) {
  Winner W = finish_hit(s, L.o, L.d, t_sph, k_sph);
  const uint32_t bsalt = hash_combine(salt, (uint32_t)depth);
  if constexpr (kExt) take_external(W, *e);
  if constexpr (kRich) take_media(W, s.med, s.n_med, L.o, L.d, bsalt);
  const float* mt = s.mat + 14 * W.m;
  return shade<float, kExt, kMoving, kRich, kParity>(
      s, W, bsalt, depth, time, mt[1], mt[2], v3(mt[6], mt[7], mt[8]),
      v3(mt[9], mt[10], mt[11]), L, slot);
}

}  // namespace srt
