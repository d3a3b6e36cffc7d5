// Closest triangle hit over the two-level BVH, one thread per ray: kernel
// B4, for meshes beyond the single-level walk's budget (teapot_scene's
// 1,278,400 triangles).
//
// Replaces srt_tpu/pallas/intersect_big.py:_kernel (launched by
// intersect_tris_pallas_big). The TPU kernel walks one scalar cursor per
// 1024-ray tile over the top tree, fetches every node scalar by a one-hot
// lane extract, and copies a whole padded cluster into VMEM (blocking DMA)
// before walking it for all 1024 lanes: a layout for the TPU's vector
// memory. Here each thread walks the top tree by its skip links for its
// own ray; at a cluster leaf whose box its ray hits, it walks that
// cluster's local skip-link tree to its end (the padding node after the
// last real node, whose skip is node_cap), then resumes at the leaf's
// skip. Records are read through the read-only path (__ldg) with the
// slab and Moller-Trumbore device functions of tri_bvh.cuh; a hit records
// the global index tri_base + k of the cluster's local triangle k.
//
// Tables (kernels/intersect.py:pack_big_tables), 9 words a record:
//   top   (n_top, 9):             lo xyz, hi xyz, skip, cluster, tri_base
//                                 (int32 bit patterns; cluster -1 inner);
//   nodes (n_cl * node_cap, 9):   lo xyz, hi xyz, local skip, first, count;
//   tris  (n_cl * tri_cap, 9):    p0 xyz, p1 xyz, p2 xyz.
// Rays are (n, 3) rows o, d; outputs t (kBig on a miss), u, v float and
// idx int32 (0 on a miss), (n,) each.
//
// The guards, the operation order and the strict < are those of the
// plain walk (render/intersect.py:intersect_tris_big); with --fmad=false
// the two agree to the bit, and both equal the single-level walk (B3) on
// the same tree.
//
// Bound: like B3, the latency of the walk's dependent loads and warp
// divergence (a warp's rays enter different clusters and leave the tree
// at different times), not bandwidth: 40 B of ray in and out per ray, and
// the clusters the wavefront enters are read once from device memory and
// then mostly from L2 (50 MB against 125 MB of padded blocks). The simple
// design accepts that: no ray sorting, no shared-memory staging of the
// top tree (1,131 records, 40 KB), no cluster prefetch.
#include <cuda_runtime.h>

#include "tri_bvh.cuh"

extern "C" {

struct IntersectBigArgs {
  const float* o;      // (n, 3)
  const float* d;      // (n, 3)
  const float* top;    // (n_top, 9)
  const float* nodes;  // (n_cl * node_cap, 9)
  const float* tris;   // (n_cl * tri_cap, 9)
  float* t;            // (n,)
  float* u;
  float* v;
  int* idx;
  int n, n_top, node_cap, tri_cap;
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kBlock = 128;

// The local walk of cluster block (nodes, tris) for one ray, from node 0
// until a skip reaches node_cap
__device__ __forceinline__ void walk_cluster(const float* __restrict__ nodes,
                                             const float* __restrict__ tris,
                                             int node_cap, int tri_base, V3 o,
                                             V3 d, V3 inv, TriHit& h) {
  int j = 0;
  while (j < node_cap) {
    const float* nd = nodes + kNodeWords * j;
    const int* ni = reinterpret_cast<const int*>(nd);
    const int skip = __ldg(ni + 6), first = __ldg(ni + 7);
    const bool box_hit = slab_test(nd, o, inv, h.t);
    if (box_hit && first >= 0) {
      const int count = __ldg(ni + 8);
      for (int k = 0; k < count; ++k)
        moller_trumbore(tris, first + k, o, d, h, tri_base);
    }
    j = (box_hit && first < 0) ? j + 1 : skip;
  }
}

__global__ void __launch_bounds__(kBlock)
intersect_big_kernel(const IntersectBigArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const V3 o = load_row3(a.o, i), d = load_row3(a.d, i);
  const V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  TriHit h;
  h.t = kBig;
  h.u = 0.0f;
  h.v = 0.0f;
  h.idx = 0;
  int c = 0;
  while (c < a.n_top) {
    const float* nd = a.top + kNodeWords * c;
    const int* ni = reinterpret_cast<const int*>(nd);
    const int skip = __ldg(ni + 6), cluster = __ldg(ni + 7);
    const bool box_hit = slab_test(nd, o, inv, h.t);
    if (box_hit && cluster >= 0) {
      const size_t cl = (size_t)cluster;
      walk_cluster(a.nodes + cl * a.node_cap * kNodeWords,
                   a.tris + cl * a.tri_cap * kTriWords, a.node_cap,
                   __ldg(ni + 8), o, d, inv, h);
    }
    c = (box_hit && cluster < 0) ? c + 1 : skip;
  }
  a.t[i] = h.t;
  a.u[i] = h.u;
  a.v[i] = h.v;
  a.idx[i] = h.idx;
}

}  // namespace

extern "C" int srt_intersect_big(const IntersectBigArgs* args,
                                 void* stream) {
  const IntersectBigArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  int blocks = (a.n + kBlock - 1) / kBlock;
  intersect_big_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
