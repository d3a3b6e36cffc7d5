// Closest hit over the triangle BVH for one ray: the stackless skip-link
// walk of srt_tpu_torch/render/intersect.py:intersect_tris, as a device
// function so a bounce kernel can call it in-line; and the arithmetic of
// its two parts, the slab test of one box and the Moller-Trumbore test of
// one triangle (slab_core, mt_core), which the two-level walk
// (intersect_big.cu) runs on the values its own records hold.
//
// Tables (kernels/intersect.py:pack_tables), read through the read-only
// path:
//   nodes (n_nodes, 9): lo xyz, hi xyz, then skip, first, count as int32
//                       bit patterns (first = -1 on an inner node);
//   tris  (n_tris, 9):  p0 xyz, p1 xyz, p2 xyz, in BVH order.
// A box test that hits an inner node descends to i + 1, anything else
// jumps to skip[i]; the ray's own best t prunes the box test. Guards and
// operation order are the plain version's: 1/d with |d| < 1e-20 replaced
// by +1e-20, 1/det with |det| < 1e-12 replaced by +1e-12, |det| > 1e-10,
// and a strict < that keeps the first triangle in walk order.
#pragma once

#include <cuda_runtime.h>

#include "bounce_core.cuh"

namespace srt {

constexpr int kNodeWords = 9;
constexpr int kTriWords = 9;

struct TriHit {
  float t;    // kBig on a miss
  float u, v;
  int idx;    // 0 on a miss
};

__device__ __forceinline__ V3 ldg3(const float* __restrict__ p) {
  return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

// Möller–Trumbore of the triangle (p0, e1 = p1 - p0, e2 = p2 - p0)
// (render/intersect.py:_tri_intersect); a hit records the index id
__device__ __forceinline__ void mt_core(V3 p0, V3 e1, V3 e2, V3 o, V3 d,
                                        TriHit& h, int id) {
  const V3 pv = cross(d, e2);
  const float det = dot(e1, pv);
  const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
  const V3 tv = sub(o, p0);
  const float u = dot(tv, pv) * inv_det;
  const V3 qv = cross(tv, e1);
  const float v = dot(d, qv) * inv_det;
  const float t = dot(e2, qv) * inv_det;
  if (fabsf(det) > 1e-10f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f
      && t > kTMin && t < h.t) {
    h.t = t;
    h.u = u;
    h.v = v;
    h.idx = id;
  }
}

// Möller–Trumbore of triangle record k; a hit records the index base + k
__device__ __forceinline__ void moller_trumbore(
    const float* __restrict__ tris, int k, V3 o, V3 d, TriHit& h,
    int base = 0) {
  const float* p = tris + kTriWords * k;
  const V3 p0 = ldg3(p), p1 = ldg3(p + 3), p2 = ldg3(p + 6);
  mt_core(p0, sub(p1, p0), sub(p2, p0), o, d, h, base + k);
}

// The slab test of the box (lo, hi) against the ray with reciprocal
// direction inv, pruned by the ray's best t
__device__ __forceinline__ bool slab_core(V3 lo, V3 hi, V3 o, V3 inv,
                                          float t_best) {
  const float t0x = (lo.x - o.x) * inv.x, t1x = (hi.x - o.x) * inv.x;
  const float t0y = (lo.y - o.y) * inv.y, t1y = (hi.y - o.y) * inv.y;
  const float t0z = (lo.z - o.z) * inv.z, t1z = (hi.z - o.z) * inv.z;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  return tf >= fmaxf(tn, kTMin) && tn < t_best;
}

// The slab test of node record nd (lo xyz, hi xyz)
__device__ __forceinline__ bool slab_test(const float* __restrict__ nd, V3 o,
                                          V3 inv, float t_best) {
  return slab_core(ldg3(nd), ldg3(nd + 3), o, inv, t_best);
}

__device__ inline TriHit walk_tri_bvh(const float* __restrict__ nodes,
                                      int n_nodes,
                                      const float* __restrict__ tris, V3 o,
                                      V3 d) {
  TriHit h;
  h.t = kBig;
  h.u = 0.0f;
  h.v = 0.0f;
  h.idx = 0;
  const V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  int i = 0;
  while (i < n_nodes) {
    const float* nd = nodes + kNodeWords * i;
    const int* ni = reinterpret_cast<const int*>(nd);
    const int skip = __ldg(ni + 6), first = __ldg(ni + 7);
    const bool box_hit = slab_test(nd, o, inv, h.t);
    if (box_hit && first >= 0) {
      const int count = __ldg(ni + 8);
      for (int j = 0; j < count; ++j)
        moller_trumbore(tris, first + j, o, d, h);
    }
    i = (box_hit && first < 0) ? i + 1 : skip;
  }
  return h;
}

}  // namespace srt
