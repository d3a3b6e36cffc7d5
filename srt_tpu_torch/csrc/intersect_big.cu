// Closest triangle hit over the two-level BVH, one thread per ray: kernel
// B4, for meshes beyond the single-level walk's budget (teapot_scene's
// 1,278,400 triangles).
//
// Replaces srt_tpu/pallas/intersect_big.py:_kernel (launched by
// intersect_tris_pallas_big). The TPU kernel walks one scalar cursor per
// 1024-ray tile over the top tree, fetches every node scalar by a one-hot
// lane extract, and copies a whole padded cluster into VMEM (blocking DMA)
// before walking it for all 1024 lanes: a layout for the TPU's vector
// memory. Here each thread walks the two-level tree for its own ray, in
// the order of the plain walk (render/intersect.py:intersect_tris_big):
// the top tree by its skip links; at a cluster leaf whose box its ray
// hits, that cluster's local skip-link tree to its end, then the leaf's
// skip. A hit records the global index tri_base + k of the cluster's
// local triangle k.
//
// Bound: not bytes (the records a wavefront reads take microseconds at
// the card's rate) but the latency of each ray's chain of dependent
// record loads, and a warp runs as long as its longest walk. The design:
//   * one loop with a phase bit. Every iteration fetches one record, top
//     or cluster, through one load whichever tree the thread is in, runs
//     one slab test, tests a leaf's triangles and picks the next record,
//     so a warp's threads advance together whichever tree each is in (two
//     nested loops made a warp pay the sum of its threads' phases);
//   * 16-byte records. A node is 32 B, two aligned float4 loads: lo xyz
//     and a link word, hi xyz and a link word. The clusters lie back to
//     back with no padding to the TPU's block size, so the walk leaves a
//     cluster when its local skip reaches the cluster's node count (the
//     plain walk visits one padding node there). A triangle is 48 B: p0,
//     e1 = p1 - p0 and e2 = p2 - p0, each padded to a float4, the edges
//     subtracted once in float32 when the tables are packed -- the same
//     subtractions, so the same bits as taking them here;
//   * the top tree read through L1 like the clusters: it is small (the
//     teapot's 1,131 records take 36 KB) and stays cached. Staging it in
//     shared memory per block (cp.async) measured slower on the H100, the
//     carve-out taking L1 from the cluster records (PERF.md, B4).
// The slab and Möller–Trumbore arithmetic and the triangle record's test
// are tri_bvh.cuh's (slab_core, mt_core, tri_test), which the single-level
// walk (B3) runs on the same records.
//
// Tables (kernels/intersect.py:pack_big_tables):
//   top      (n_top, 2) float4:  lo xyz + skip, hi xyz + cluster (-1 inner);
//   nodes    (n_nodes, 2) float4: lo xyz + local skip, hi xyz + link, the
//                                 link first << count_bits | count (a
//                                 negative link marks an inner node);
//   tris     (n_tris, 3) float4: p0, e1, e2 (w unused);
//   clusters (n_cl,) int4:       node base, triangle base in tris,
//                                 tri_base (global index of triangle 0),
//                                 node count.
// Rays are (n, 3) rows o, d; outputs t (kBig on a miss), u, v float and
// idx int32 (0 on a miss), (n,) each.
//
// The guards, the operation order and the strict < are those of the
// plain walk; with --fmad=false the two agree to the bit, and both equal
// the single-level walk (B3) on the same tree.
#include <cuda_runtime.h>

#include "tri_bvh.cuh"

extern "C" {

struct IntersectBigArgs {
  const float* o;          // (n, 3)
  const float* d;          // (n, 3)
  const float4* top;       // (n_top, 2)
  const float4* nodes;     // (n_nodes, 2)
  const float4* tris;      // (n_tris, 3)
  const int4* clusters;    // (n_cl,)
  float* t;                // (n,)
  float* u;
  float* v;
  int* idx;
  int n, n_top, count_bits;
};

}  // extern "C"

namespace {

using namespace srt;

// threads a block: of 128, 256 and 512, 256 was the fastest on the
// teapot's bounced rays on one H100 (PERF.md, B4)
constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
intersect_big_kernel(const IntersectBigArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const V3 o = load_row3(a.o, i), d = load_row3(a.d, i);
  const V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  const int mask = (1 << a.count_bits) - 1;
  TriHit h;
  h.t = kBig;
  h.u = 0.0f;
  h.v = 0.0f;
  h.idx = 0;
  // the walk state: the record c, in the top tree or, inside a cluster,
  // its local node; the cluster's row and the top skip to resume at
  bool inside = false;
  int c = 0, resume = 0;
  int4 cl = make_int4(0, 0, 0, 0);
  while (inside || c < a.n_top) {
    const float4* r = inside ? a.nodes + 2 * (size_t)(cl.x + c)
                             : a.top + 2 * c;
    const float4 lo = __ldg(r), hi = __ldg(r + 1);
    const bool box_hit = slab_core(xyz(lo), xyz(hi), o, inv, h.t);
    const int skip = __float_as_int(lo.w), link = __float_as_int(hi.w);
    if (inside) {
      if (box_hit && link >= 0) {
        const int first = link >> a.count_bits, count = link & mask;
        for (int k = first; k < first + count; ++k)
          tri_test(a.tris, cl.y + k, o, d, h, cl.z + k);
      }
      c = (box_hit && link < 0) ? c + 1 : skip;
      if (c >= cl.w) {        // past the cluster's last node
        inside = false;
        c = resume;
      }
    } else if (box_hit && link >= 0) {   // a cluster leaf: enter it
      cl = __ldg(a.clusters + link);
      resume = skip;
      inside = true;
      c = 0;
    } else {
      c = (box_hit && link < 0) ? c + 1 : skip;
    }
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
  const int blocks = (a.n + kBlock - 1) / kBlock;
  intersect_big_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
