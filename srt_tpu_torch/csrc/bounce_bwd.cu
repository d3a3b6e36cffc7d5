// The VJP of one bounce (bounce.cu), one thread per lane: the backward of
// the train step. Two instantiations, chosen on the host (args.rich): the
// lean one for scenes with none of scene/ir.py:rich_families
// (ball_scenes), and the rich one (kRich) for scenes with any of them --
// the specular branch, sphere and box media, checker, noise and image
// textures, sphere lights -- which bounce.cu's rich instantiation shades
// forward.
//
// Replaces srt_tpu/pallas/bounce_bwd.py:_bwd_kernel (:76, launched by
// fused_bounce_bwd at :277) under frozen geometry. Per lane, as the TPU
// kernel:
//   1. replay the closest-hit sweep in float (bounce_core.cuh), which gives
//      the forward's winner, hit frame and branch decisions (static spheres:
//      a scene with moving spheres takes the hybrid backward,
//      kernels/bounce_vjp.py); the rich instantiation also replays the
//      media sweep (take_media), so its winner's material is the
//      post-media one, as w_mat_post (:137-141, :217);
//   2. recompute the winner's t from (o, d) with tangents: the surface's
//      (hit_t), the same value bit for bit, or for a medium event where
//      the ray enters the medium plus the free flight, in the safe_ad
//      forms of _media_sweep (srt_tpu/pallas/bounce.py:505, :511);
//   3. differentiate the shading (shade<Dual<K>, ..., kRich>, the forward's
//      own code) with respect to o, d, beta (9 inputs) and the winner's
//      material fields the shading reads, in forward-mode passes of K
//      tangents, each Jacobian column contracted with the incoming
//      cotangent. Radiance is added to, so its cotangent passes through.
//      Lean: parameters 0 and 1 and the colour (5 inputs, 14 columns, two
//      passes of K = 7); the second colour is read by no lean branch.
//      Rich: those and the second colour (8 inputs, 17 columns, three
//      passes of K = 6, which spill less than two of nine: the marble and
//      the sphere light's basis keep many duals live). Parameters 2 and 3
//      are read by no branch of the JAX kernel's _shade_core: their
//      cotangents are 0. Textures follow what JAX's train step computes:
//      the checker's colours take the cotangents of its two colours; the
//      marble is differentiated in the hit point (JAX's epilogue
//      differentiates it through out["o"], bounce.py:1555-1595); the image
//      lookup is nearest-texel, so its uv has no tangent
//      (bounce_vjp.py:110-112). Sphere-light samples and pdfs take
//      tangents in the hit point and the direction;
//   4. write the state cotangents, the ten per-lane material cotangents
//      and the winner's material id. kernels/bounce_bwd.py segment-sums
//      the material cotangents into the (M, 14) table with index_add_.
// Dead lanes and misses pass their cotangents through (the forward leaves
// their o, d, beta, radiance as they were).
//
// Bound: registers and local memory. Each Dual<K> value is K + 1 floats
// and the Beckmann chain keeps dozens live, so the passes spill; the design
// takes that for a first kernel (128-thread blocks so 16,384 lanes still
// give every SM a block). The rich instantiation stages the Perlin tables
// in shared memory as B1 and B2 do (stage_rich) and reads the media and
// the lights' kinds from global memory.
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
  const float* med;             // (n_med, 10) media (rich)
  int n_med;
  int rich;                     // the rich instantiation (kRich)
  const int* light_kind;        // (n_light,) 0 rect, 1 sphere (rich)
  const float* perlin_vec;      // (256, 3) (rich)
  const int* perlin_perm;       // (3, 256) (rich)
  int perlin;                   // stage the Perlin tables (noise)
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kBlock = 128;

struct Rows {
  V3 o, d, beta, rad;
};
template <int K>
struct Contracted {
  float g[K];
};

__device__ __forceinline__ Rows load_rows(const float* o, const float* d,
                                          const float* beta, const float* rad,
                                          int i) {
  Rows r;
  r.o = load_row3(o, i);
  r.d = load_row3(d, i);
  r.beta = load_row3(beta, i);
  r.rad = load_row3(rad, i);
  return r;
}

// v as a value whose tangent k is 1 where Jacobian column ``col`` is the
// pass's column base + k
template <int K>
__device__ __forceinline__ Dual<K> seed(float v, int col, int base) {
  Dual<K> r(v);
#pragma unroll
  for (int k = 0; k < K; ++k) r.t[k] = col == base + k ? 1.0f : 0.0f;
  return r;
}
template <int K>
__device__ __forceinline__ V3T<Dual<K>> seed3(V3 a, int col, int base) {
  return v3<Dual<K>>(seed<K>(a.x, col, base), seed<K>(a.y, col + 1, base),
                     seed<K>(a.z, col + 2, base));
}
template <int K>
__device__ __forceinline__ float contract3(V3 ct, const V3T<Dual<K>>& out,
                                           int k) {
  return ct.x * out.x.t[k] + ct.y * out.y.t[k] + ct.z * out.z.t[k];
}

// One forward-mode pass: columns base .. base + K - 1 of the Jacobian of
// (o', d', beta', radiance'), contracted with the cotangent.
template <int K, bool kRich>
__device__ __noinline__ Contracted<K> vjp_pass(const SceneView& s,
                                               const Winner& W,
                                               uint32_t salt, int depth,
                                               const Rows& in,
                                               const Rows& ct, int base) {
  using D = Dual<K>;
  const float* mt = s.mat + 14 * W.m;
  LaneT<D> L;
  L.o = seed3<K>(in.o, 0, base);
  L.d = seed3<K>(in.d, 3, base);
  L.beta = seed3<K>(in.beta, 6, base);
  L.rad = lift3<D>(in.rad);
  const D p0 = seed<K>(mt[1], 9, base), p1 = seed<K>(mt[2], 10, base);
  const V3T<D> mc = seed3<K>(v3(mt[6], mt[7], mt[8]), 11, base);
  if constexpr (kRich) {
    const V3T<D> mc2 = seed3<K>(v3(mt[9], mt[10], mt[11]), 14, base);
    shade<D, false, false, true>(s, W, salt, depth, 0.0f, p0, p1, mc, mc2,
                                 L);
  } else {
    // the lean shading reads no second colour
    shade<D>(s, W, salt, depth, 0.0f, p0, p1, mc, mc, L);
  }
  Contracted<K> c;
#pragma unroll
  for (int k = 0; k < K; ++k)
    c.g[k] = contract3(ct.o, L.o, k) + contract3(ct.d, L.d, k)
             + contract3(ct.beta, L.beta, k) + contract3(ct.rad, L.rad, k);
  return c;
}

template <int K, bool kRich>
__global__ void __launch_bounds__(kBlock)
bounce_bwd_kernel(const BounceBwdArgs a) {
  // o(3) d(3) beta(3) p0 p1 colour(3), and the rich second colour(3)
  constexpr int kCols = kRich ? 17 : 14;
  extern __shared__ float smem[];
  SceneView sv = scene_view(a, smem);
  if constexpr (kRich) stage_rich(sv, smem, a);
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const Rows in = load_rows(a.o, a.d, a.beta, a.rad, i);
  const Rows ct = load_rows(a.ct_o, a.ct_d, a.ct_beta, a.ct_rad, i);

  // the material columns start at 0 (aggregate initialisation)
  float g[kCols] = {ct.o.x, ct.o.y, ct.o.z, ct.d.x, ct.d.y, ct.d.z,
                    ct.beta.x, ct.beta.y, ct.beta.z};
  int m = 0;
  if (a.alive[i]) {
    Winner W = closest_hit(sv, in.o, in.d);
    const int depth = a.depth[i];
    const uint32_t salt = hash_combine((uint32_t)a.salt[i],
                                       (uint32_t)depth);
    if constexpr (kRich) take_media(W, sv.med, sv.n_med, in.o, in.d, salt);
    if (W.hit) {
      m = W.m;
#pragma unroll
      for (int base = 0; base < kCols; base += K) {
        const Contracted<K> c = vjp_pass<K, kRich>(sv, W, salt, depth, in,
                                                   ct, base);
#pragma unroll
        for (int k = 0; k < K; ++k)
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
  gm[2] = 0.0f;    // parameters 2-3: read by no branch
  gm[3] = 0.0f;
  gm[4] = g[11];   // colour (columns 6-8)
  gm[5] = g[12];
  gm[6] = g[13];
  if constexpr (kRich) {   // second colour (columns 9-11)
    gm[7] = g[14];
    gm[8] = g[15];
    gm[9] = g[16];
  } else {
    gm[7] = 0.0f;
    gm[8] = 0.0f;
    gm[9] = 0.0f;
  }
  a.wmat[i] = m;
}

template <int K, bool kRich>
int launch(const BounceBwdArgs& a, cudaStream_t stream) {
  size_t smem = srt::smem_bytes(a.n_sph, a.n_rect, a.n_mat, a.n_light)
                + (kRich ? srt::rich_smem_bytes(a.perlin) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      bounce_bwd_kernel<K, kRich>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (a.n + kBlock - 1) / kBlock;
  bounce_bwd_kernel<K, kRich><<<blocks, kBlock, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int srt_bounce_bwd(const BounceBwdArgs* args, void* stream) {
  const BounceBwdArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return a.rich ? launch<6, true>(a, s) : launch<7, false>(a, s);
}
