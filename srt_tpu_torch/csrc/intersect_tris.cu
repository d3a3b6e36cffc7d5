// Closest triangle hit for a batch of rays over the single-level BVH, each
// ray's walk on G threads: kernel B3.
//
// Replaces srt_tpu/pallas/intersect.py:_kernel (launched by
// intersect_tris_pallas), which walks one scalar cursor per 1024-ray tile
// over the union of the nodes its rays need and fetches each node scalar
// by a one-hot lane extract -- a layout for the TPU's vector memory. Here
// each ray walks the stackless skip-link BVH in the plain walk's order
// (render/intersect.py:intersect_tris): a box test that hits an inner node
// descends to c + 1, anything else jumps to the node's skip; the ray's own
// best t prunes the box test.
//
// Bound: bytes are small (24 B of ray in and 16 B out a ray, tables the
// JAX kernel's gate caps at 6 MB, far inside the H100's 50 MB L2); the
// work is each ray's chain of dependent node loads and the triangle tests
// of the leaves it reaches, and a warp runs as long as its longest walk.
// The design:
//   * B4's 16-byte records (kernels/intersect.py:pack_tables): a node is
//     two aligned float4 loads, lo xyz + skip and hi xyz + the link
//     first << count_bits | count (negative on an inner node); a triangle
//     is three, p0, e1 = p1 - p0 and e2 = p2 - p0, the edges subtracted
//     once in float32 at packing -- the same subtractions, so the same
//     bits as taking them here. slab_core, mt_core and tri_test are B4's
//     (tri_bvh.cuh);
//   * G threads a ray (G = 1, 2 or 4, at most the widest leaf), G
//     neighbouring lanes of one warp, all on the same node path: at a
//     leaf whose box is hit, share p tests triangles first + p,
//     first + p + G, ... against the ray's best, and the shares' bests
//     are folded (warp shuffles over the ray's lanes) before the next
//     box test, so pruning is the plain walk's. Every triangle a share
//     keeps is strictly nearer than the best before the leaf, so the
//     fold -- the nearest, the lowest index on a tie -- gives the plain
//     walk's first nearest in walk order. More threads a ray puts more
//     warps in flight to hide the node loads' latency at the train
//     state's 16,384 rays, and takes the leaf's tests off one thread;
//     the host picks G by rays (kernels/intersect.py:walk_shares);
//   * one walk for every table the single-level gate admits: the tables
//     are read through the read-only path and stay in L1/L2. Staging
//     them in shared memory would give two walks by table size, and
//     took L1 from the records when B4's top tree was staged (PERF.md).
//
// Rays are (n, 3) rows o, d; outputs t (kBig on a miss), u, v float and
// idx int32 (0 on a miss), (n,) each. With --fmad=false the walk equals
// the plain one to the bit at every G.
#include <cuda_runtime.h>

#include "tri_bvh.cuh"

extern "C" {

struct IntersectTrisArgs {
  const float* o;        // (n, 3)
  const float* d;        // (n, 3)
  const float4* nodes;   // (n_nodes, 2)
  const float4* tris;    // (n_tris, 3)
  float* t;              // (n,)
  float* u;
  float* v;
  int* idx;
  int n, n_nodes, count_bits;
  int shares;            // threads a ray, G: 1, 2 or 4
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kBlock = 128;   // threads a block, 128 / G rays

// The best of the ray's G shares, on each of its G lanes: the nearest t,
// the lowest index on a tie
template <int G>
__device__ __forceinline__ void fold_shares(TriHit& h) {
  const unsigned lane = threadIdx.x % 32;
  const unsigned mask = ((1u << G) - 1u) << (lane & ~(G - 1u));
#pragma unroll
  for (int m = 1; m < G; m <<= 1) {
    const float t = __shfl_xor_sync(mask, h.t, m);
    const float u = __shfl_xor_sync(mask, h.u, m);
    const float v = __shfl_xor_sync(mask, h.v, m);
    const int idx = __shfl_xor_sync(mask, h.idx, m);
    if (t < h.t || (t == h.t && idx < h.idx)) {
      h.t = t;
      h.u = u;
      h.v = v;
      h.idx = idx;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kBlock)
intersect_tris_kernel(const IntersectTrisArgs a) {
  const int p = threadIdx.x % G;
  const int i = (blockIdx.x * kBlock + threadIdx.x) / G;
  if (i >= a.n) return;   // all G lanes of the ray
  const V3 o = load_row3(a.o, i), d = load_row3(a.d, i);
  const V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  const int mask = (1 << a.count_bits) - 1;
  TriHit h;
  h.t = kBig;
  h.u = 0.0f;
  h.v = 0.0f;
  h.idx = 0;
  int c = 0;
  while (c < a.n_nodes) {
    const float4* r = a.nodes + 2 * (size_t)c;
    const float4 lo = __ldg(r), hi = __ldg(r + 1);
    const bool box_hit = slab_core(xyz(lo), xyz(hi), o, inv, h.t);
    const int skip = __float_as_int(lo.w), link = __float_as_int(hi.w);
    if (box_hit && link >= 0) {
      const int first = link >> a.count_bits;
      const int end = first + (link & mask);
      for (int k = first + p; k < end; k += G)
        tri_test(a.tris, k, o, d, h, k);
      if constexpr (G > 1) fold_shares<G>(h);
    }
    c = (box_hit && link < 0) ? c + 1 : skip;
  }
  if (p == 0) {
    a.t[i] = h.t;
    a.u[i] = h.u;
    a.v[i] = h.v;
    a.idx[i] = h.idx;
  }
}

template <int G>
int launch_walk(const IntersectTrisArgs& a, cudaStream_t stream) {
  const int blocks = (int)(((long long)a.n * G + kBlock - 1) / kBlock);
  intersect_tris_kernel<G><<<blocks, kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int srt_intersect_tris(const IntersectTrisArgs* args,
                                  void* stream) {
  const IntersectTrisArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (a.shares) {
    case 1: return launch_walk<1>(a, s);
    case 2: return launch_walk<2>(a, s);
    case 4: return launch_walk<4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
