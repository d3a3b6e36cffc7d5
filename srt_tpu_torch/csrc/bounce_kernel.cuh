// Kernel B2, the per-bounce step, as bounce.cu describes it: its
// argument struct, the kernel and its launch, included by bounce.cu
// and bounce_g{2,4,8}.cu, each of which instantiates one G.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_core.cuh"

extern "C" {

struct BounceArgs {
  const float* o;               // (n, 3) ray origins
  const float* d;               // (n, 3) unit directions
  const float* beta;            // (n, 3) throughput
  const float* rad;             // (n, 3) radiance
  const int* salt;              // (n,) 32-bit sampler words
  const int* depth;             // (n,)
  const unsigned char* alive;   // (n,) bool
  float* o_out;
  float* d_out;
  float* beta_out;
  float* rad_out;
  int* depth_out;
  unsigned char* alive_out;     // before the depth cap
  const float* sph;             // (n_sph, 12)
  const float* rect;            // (n_rect, 10)
  const float* mat;             // (n_mat, 14)
  const float* light;           // (n_light, 8) rect lights
  const int* tex_img;           // (n_tex, 3) atlas offset, nx, ny
  const void* atlas;            // texels: packed rgb8, or 3 floats
  int n, n_sph, n_rect, n_mat, n_light, n_atlas, atlas_f32, max_depth,
      rr_start;
  float pdf_floor;
  const float* tri_t;           // (n,) closest triangle: t, kBig on a miss
  const float* tri_u;           // (n,)
  const float* tri_v;           // (n,)
  const int* tri_idx;           // (n,)
  const float* tri_n;           // (n_tris, 9) per-vertex shading normals
  const float* tri_uv;          // (n_tris, 6) per-vertex uv
  const int* tri_mat;           // (n_tris,)
  int n_tris;                   // 0: no external hit
  const float* med;             // (n_med, 10) media (rich)
  int n_med;
  const float* time;            // (n,) ray times (read when moving)
  int moving;                   // spheres move over the shutter interval
  int rich;                     // the rich instantiation (kRich)
  const int* light_kind;        // (n_light,) 0 rect, 1 sphere (rich)
  const float* perlin_vec;      // (256, 3) (rich)
  const int* perlin_perm;       // (3, 256) (rich)
  int perlin;                   // stage the Perlin tables (noise)
  float* stale_out;             // (n,) the heap slot after the bounce
  int parity;                   // the parity estimator (kParity)
  int parity_no_stale;          // parity: the slot reads 0
  int shares;                   // threads a lane, G: 1, 2, 4 or 8
  long long* live;              // null, or where to add the lanes live on
                                // entry (the program's tracer)
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kLanes = 64;   // lanes a block

// Lane i's closest triangle as an external hit (intersect.py:396-403)
__device__ __forceinline__ ExtHit triangle_hit(const BounceArgs& a, int i) {
  ExtHit e;
  e.t = a.tri_t[i];
  e.u = e.v = 0.0f;
  e.n = v3(0.0f, 0.0f, 0.0f);
  e.m = 0;
  e.idx = -1;
  if (e.t < kBig) {
    const float u = a.tri_u[i], v = a.tri_v[i];
    const float w = 1.0f - u - v;
    const int k = a.tri_idx[i];
    const float* nn = a.tri_n + 9 * k;
    const float* uu = a.tri_uv + 6 * k;
    e.n = normalize(v3(nn[0] * w + nn[3] * u + nn[6] * v,
                       nn[1] * w + nn[4] * u + nn[7] * v,
                       nn[2] * w + nn[5] * u + nn[8] * v));
    e.u = uu[0] * w + uu[2] * u + uu[4] * v;
    e.v = uu[1] * w + uu[3] * u + uu[5] * v;
    e.m = a.tri_mat[k];
    e.idx = k;
  }
  return e;
}

template <bool kExt, bool kMoving, bool kRich, bool kParity, int G>
__global__ void __launch_bounds__(kLanes * G)
bounce_kernel(const BounceArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_share_t[G][kLanes];
  __shared__ int s_share_k[G][kLanes];
  SceneView sv = scene_view(a, smem);
  if constexpr (kRich) stage_rich(sv, smem, a);
  const int p = threadIdx.x / kLanes, l = threadIdx.x % kLanes;
  const int i = blockIdx.x * kLanes + l;
  const bool live = i < a.n && a.alive[i];
  // the tracer's count: one add a warp of share 0 (p is warp-uniform)
  if (a.live != nullptr && p == 0) {
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0 && ballot != 0u)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.live),
                (unsigned long long)__popc(ballot));
  }
  LaneT<float> L;
  if (i < a.n) {
    L.o = load_row3(a.o, i);
    L.d = load_row3(a.d, i);
  }
  const float time = kMoving && live ? a.time[i] : 0.0f;
  __syncthreads();   // the tables are staged
  float t_sph = kBig;
  int k_sph = -1;
  if (live) sphere_share<kMoving>(sv, L.o, L.d, time, p, G, t_sph, k_sph);
  if constexpr (G > 1) {
    s_share_t[p][l] = t_sph;
    s_share_k[p][l] = k_sph;
    __syncthreads();
    if (p != 0) return;
    for (int q = 1; q < G; ++q)
      nearest_share(s_share_t[q][l], s_share_k[q][l], t_sph, k_sph);
  }
  if (i >= a.n) return;
  L.beta = load_row3(a.beta, i);
  L.rad = load_row3(a.rad, i);
  const int depth = a.depth[i];
  // the heap slot, on every lane (the default instantiations have none)
  float slot = 0.0f;
  if constexpr (kParity)
    slot = parity_slot(hash_combine((uint32_t)a.salt[i], (uint32_t)depth),
                       a.parity_no_stale);
  float* const slot_p = kParity ? &slot : nullptr;
  bool alive = false;
  if (live) {
    if constexpr (kExt) {
      const ExtHit e = triangle_hit(a, i);
      alive = bounce<true, kMoving, kRich, kParity>(
          sv, (uint32_t)a.salt[i], depth, time, L, t_sph, k_sph, &e, slot_p);
    } else {
      alive = bounce<false, kMoving, kRich, kParity>(
          sv, (uint32_t)a.salt[i], depth, time, L, t_sph, k_sph, nullptr,
          slot_p);
    }
  }
  if constexpr (kParity) a.stale_out[i] = slot;
  store_row3(a.o_out, i, L.o);
  store_row3(a.d_out, i, L.d);
  store_row3(a.beta_out, i, L.beta);
  store_row3(a.rad_out, i, L.rad);
  a.depth_out[i] = depth + 1;
  a.alive_out[i] = alive ? 1 : 0;
}

template <bool kExt, bool kMoving, bool kRich, bool kParity, int G>
int launch_bounce(const BounceArgs& a, cudaStream_t stream) {
  size_t smem = srt::smem_bytes(a.n_sph, a.n_rect, a.n_mat, a.n_light)
                + (kRich ? srt::rich_smem_bytes(a.perlin) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      bounce_kernel<kExt, kMoving, kRich, kParity, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (a.n + kLanes - 1) / kLanes;
  bounce_kernel<kExt, kMoving, kRich, kParity, G>
      <<<blocks, kLanes * G, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kExt, bool kRich, bool kParity, int G>
int launch_moving(const BounceArgs& a, cudaStream_t stream) {
  return a.moving ? launch_bounce<kExt, true, kRich, kParity, G>(a, stream)
                  : launch_bounce<kExt, false, kRich, kParity, G>(a, stream);
}

template <bool kExt, bool kRich, int G>
int launch_parity(const BounceArgs& a, cudaStream_t stream) {
  return a.parity ? launch_moving<kExt, kRich, true, G>(a, stream)
                  : launch_moving<kExt, kRich, false, G>(a, stream);
}

}  // namespace

namespace srt {

// One launch of B2 with G threads a lane, the instantiation picked from
// ``a``: defined here, instantiated in one source file for each G
template <int G>
int launch_shares(const BounceArgs& a, cudaStream_t stream) {
  if (a.n_tris > 0)
    return a.rich ? launch_parity<true, true, G>(a, stream)
                  : launch_parity<true, false, G>(a, stream);
  return a.rich ? launch_parity<false, true, G>(a, stream)
                : launch_parity<false, false, G>(a, stream);
}

extern template int launch_shares<1>(const BounceArgs&, cudaStream_t);
extern template int launch_shares<2>(const BounceArgs&, cudaStream_t);
extern template int launch_shares<4>(const BounceArgs&, cudaStream_t);
extern template int launch_shares<8>(const BounceArgs&, cudaStream_t);

}  // namespace srt
