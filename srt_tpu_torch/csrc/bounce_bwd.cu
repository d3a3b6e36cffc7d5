// The VJP of one bounce (bounce.cu), one thread per lane: the backward of
// the train step.
//
// Replaces srt_tpu/pallas/bounce_bwd.py:_bwd_kernel (launched by
// fused_bounce_bwd) under frozen geometry. Per lane, as the TPU kernel:
//   1. replay the closest-hit sweep in float (bounce_core.cuh), which gives
//      the forward's winner, hit frame and branch decisions;
//   2. recompute the winner's t from (o, d) with the sweep's formulas, the
//      same value bit for bit, now with tangents (hit_t);
//   3. differentiate the shading (shade<Dual<K>>, the forward's own code)
//      with respect to o, d, beta (9 inputs) and the winner's material
//      fields that the slice's shading reads -- parameters 0 and 1 and
//      the constant colour (5 inputs): two forward-mode passes of K = 7
//      tangents, each Jacobian column contracted with the incoming
//      cotangent. Radiance is added to, so its cotangent passes through.
//      The remaining material fields of the JAX kernel's ten (parameters
//      2-3, the second colour) are not read by Oren-Nayar, Beckmann or a
//      diffuse light: their cotangents are 0;
//   4. write the state cotangents, the ten per-lane material cotangents
//      and the winner's material id. kernels/bounce_bwd.py segment-sums
//      the material cotangents into the (M, 14) table with index_add_.
// Dead lanes and misses pass their cotangents through (the forward leaves
// their o, d, beta, radiance as they were).
//
// Bound: registers and local memory. Each Dual<7> value is 8 floats and
// the Beckmann chain keeps dozens live, so the passes spill; the design
// takes that for a first kernel (128-thread blocks so 16,384 lanes still
// give every SM a block).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_core.cuh"

extern "C" {

struct BounceBwdArgs {
  const float* o;               // (n, 3) the forward's inputs
  const float* d;
  const float* beta;
  const float* rad;
  const int* salt;
  const int* depth;
  const unsigned char* alive;
  const float* ct_o;            // (n, 3) cotangents of the outputs
  const float* ct_d;
  const float* ct_beta;
  const float* ct_rad;
  float* g_o;                   // (n, 3) cotangents of the inputs
  float* g_d;
  float* g_beta;
  float* g_rad;
  float* g_mat;                 // (n, 10) material fields 1-4, 6-11
  int* wmat;                    // (n,) the winner's material id
  const float* sph;
  const float* rect;
  const float* mat;
  const float* light;
  const int* tex_img;
  const int* atlas_u32;
  int n, n_sph, n_rect, n_mat, n_light, n_atlas, max_depth, rr_start;
  float pdf_floor;
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kBlock = 128;
constexpr int kTan = 7;     // tangents per pass
constexpr int kCols = 14;   // o(3) d(3) beta(3) p0 p1 colour(3)
using D = Dual<kTan>;

struct Rows {
  V3 o, d, beta, rad;
};
struct Contracted {
  float g[kTan];
};

__device__ __forceinline__ D seed(float v, int col, int base) {
  D r(v);
#pragma unroll
  for (int k = 0; k < kTan; ++k) r.t[k] = col == base + k ? 1.0f : 0.0f;
  return r;
}
__device__ __forceinline__ V3T<D> seed3(V3 a, int col, int base) {
  return v3<D>(seed(a.x, col, base), seed(a.y, col + 1, base),
               seed(a.z, col + 2, base));
}
__device__ __forceinline__ float contract3(V3 ct, const V3T<D>& out, int k) {
  return ct.x * out.x.t[k] + ct.y * out.y.t[k] + ct.z * out.z.t[k];
}

// One forward-mode pass: columns base .. base + kTan - 1 of the Jacobian
// of (o', d', beta', radiance'), contracted with the cotangent.
__device__ __noinline__ Contracted vjp_pass(const SceneView& s,
                                            const Winner& W, uint32_t salt,
                                            int depth, const Rows& in,
                                            const Rows& ct, int base) {
  const float* mt = s.mat + 14 * W.m;
  LaneT<D> L;
  L.o = seed3(in.o, 0, base);
  L.d = seed3(in.d, 3, base);
  L.beta = seed3(in.beta, 6, base);
  L.rad = lift3<D>(in.rad);
  const D p0 = seed(mt[1], 9, base), p1 = seed(mt[2], 10, base);
  const V3T<D> mc = v3<D>(seed(mt[6], 11, base), seed(mt[7], 12, base),
                          seed(mt[8], 13, base));
  shade<D>(s, W, salt, depth, p0, p1, mc, L);
  Contracted c;
#pragma unroll
  for (int k = 0; k < kTan; ++k)
    c.g[k] = contract3(ct.o, L.o, k) + contract3(ct.d, L.d, k)
             + contract3(ct.beta, L.beta, k) + contract3(ct.rad, L.rad, k);
  return c;
}

__global__ void __launch_bounds__(kBlock)
bounce_bwd_kernel(const BounceBwdArgs a) {
  extern __shared__ float smem[];
  const SceneView sv = scene_view(a, smem);
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  Rows in, ct;
  in.o = load_row3(a.o, i);
  in.d = load_row3(a.d, i);
  in.beta = load_row3(a.beta, i);
  in.rad = load_row3(a.rad, i);
  ct.o = load_row3(a.ct_o, i);
  ct.d = load_row3(a.ct_d, i);
  ct.beta = load_row3(a.ct_beta, i);
  ct.rad = load_row3(a.ct_rad, i);

  float g[kCols] = {ct.o.x, ct.o.y, ct.o.z, ct.d.x, ct.d.y, ct.d.z,
                    ct.beta.x, ct.beta.y, ct.beta.z, 0.0f, 0.0f, 0.0f, 0.0f,
                    0.0f};
  int m = 0;
  if (a.alive[i]) {
    const Winner W = closest_hit(sv, in.o, in.d);
    if (W.hit) {
      m = W.m;
      const int depth = a.depth[i];
      const uint32_t salt = hash_combine((uint32_t)a.salt[i],
                                         (uint32_t)depth);
#pragma unroll
      for (int base = 0; base < kCols; base += kTan) {
        const Contracted c = vjp_pass(sv, W, salt, depth, in, ct, base);
#pragma unroll
        for (int k = 0; k < kTan; ++k)
          if (base + k < kCols) g[base + k] = c.g[k];
      }
    }
  }
  store_row3(a.g_o, i, v3(g[0], g[1], g[2]));
  store_row3(a.g_d, i, v3(g[3], g[4], g[5]));
  store_row3(a.g_beta, i, v3(g[6], g[7], g[8]));
  store_row3(a.g_rad, i, ct.rad);
  float* gm = a.g_mat + 10 * i;
  gm[0] = g[9];    // parameter 0 (table column 1)
  gm[1] = g[10];   // parameter 1
  gm[2] = 0.0f;
  gm[3] = 0.0f;
  gm[4] = g[11];   // constant colour (columns 6-8)
  gm[5] = g[12];
  gm[6] = g[13];
  gm[7] = 0.0f;    // second colour (columns 9-11)
  gm[8] = 0.0f;
  gm[9] = 0.0f;
  a.wmat[i] = m;
}

}  // namespace

extern "C" int srt_bounce_bwd(const BounceBwdArgs* args, void* stream) {
  const BounceBwdArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  size_t smem = srt::smem_bytes(a.n_sph, a.n_rect, a.n_mat, a.n_light);
  cudaError_t err = cudaFuncSetAttribute(
      bounce_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (a.n + kBlock - 1) / kBlock;
  bounce_bwd_kernel<<<blocks, kBlock, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
