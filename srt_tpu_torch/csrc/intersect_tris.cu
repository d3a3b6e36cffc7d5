// Closest triangle hit for a batch of rays, one thread per ray: kernel B3.
//
// Replaces srt_tpu/pallas/intersect.py:_kernel (launched by
// intersect_tris_pallas), which walks one scalar cursor per 1024-ray tile
// over the union of the nodes its rays need and fetches each node scalar
// by a one-hot lane extract -- a layout for the TPU's vector memory. Here
// each thread walks the stackless skip-link BVH for its own ray
// (tri_bvh.cuh:walk_tri_bvh); the tables are read through the read-only
// path and stay in L1/L2 (the JAX kernel's gate caps them at 6 MB, far
// inside the H100's 50 MB L2).
//
// Rays are (n, 3) rows o, d; outputs t (kBig on a miss), u, v float and
// idx int32 (0 on a miss), (n,) each.
//
// Bound: bytes are small (24 B of ray in and 16 B out per ray); the work
// is the node visits and triangle tests per ray, and the limit is the
// latency of the walk's dependent loads and warp divergence (rays of one
// warp leave the tree at different times), not memory bandwidth. The
// simple design accepts that: no ray sorting, no packet traversal.
#include <cuda_runtime.h>

#include "tri_bvh.cuh"

extern "C" {

struct IntersectTrisArgs {
  const float* o;      // (n, 3)
  const float* d;      // (n, 3)
  const float* nodes;  // (n_nodes, 9)
  const float* tris;   // (n_tris, 9)
  float* t;            // (n,)
  float* u;
  float* v;
  int* idx;
  int n, n_nodes;
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
intersect_tris_kernel(const IntersectTrisArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const TriHit h = walk_tri_bvh(a.nodes, a.n_nodes, a.tris,
                                load_row3(a.o, i), load_row3(a.d, i));
  a.t[i] = h.t;
  a.u[i] = h.u;
  a.v[i] = h.v;
  a.idx[i] = h.idx;
}

}  // namespace

extern "C" int srt_intersect_tris(const IntersectTrisArgs* args,
                                  void* stream) {
  const IntersectTrisArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  int blocks = (a.n + kBlock - 1) / kBlock;
  intersect_tris_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
