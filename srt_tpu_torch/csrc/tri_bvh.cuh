// The arithmetic of the triangle BVH walks, B3 (intersect_tris.cu) and B4
// (intersect_big.cu): the slab test of one box and the Möller–Trumbore
// test of one triangle (slab_core, mt_core), and the 48-byte triangle
// record both walks read (tri_test).
//
// Guards and operation order are the plain walk's
// (srt_tpu_torch/render/intersect.py:intersect_tris): 1/d with |d| < 1e-20
// replaced by +1e-20, 1/det with |det| < 1e-12 replaced by +1e-12,
// |det| > 1e-10, and a strict < that keeps the first triangle in walk
// order.
#pragma once

#include <cuda_runtime.h>

#include "bounce_core.cuh"

namespace srt {

struct TriHit {
  float t;    // kBig on a miss
  float u, v;
  int idx;    // 0 on a miss
};

__device__ __forceinline__ V3 xyz(float4 a) { return v3(a.x, a.y, a.z); }

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

// Möller–Trumbore of the 48-byte triangle record k (p0, e1, e2, each
// padded to a float4; kernels/intersect.py packs them); a hit records the
// index id
__device__ __forceinline__ void tri_test(const float4* __restrict__ tris,
                                         int k, V3 o, V3 d, TriHit& h,
                                         int id) {
  const float4* r = tris + 3 * (size_t)k;
  mt_core(xyz(__ldg(r)), xyz(__ldg(r + 1)), xyz(__ldg(r + 2)), o, d, h, id);
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

}  // namespace srt
