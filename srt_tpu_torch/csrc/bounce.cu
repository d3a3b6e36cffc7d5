// One bounce of an explicit wavefront state, one thread per lane: the
// forward of the train step, and the bounce of the regeneration engine on
// triangle scenes.
//
// Replaces srt_tpu/pallas/bounce.py:_kernel in its per-bounce mode
// (regen=False, launched by fused_bounce), its parity plane included. For
// every lane: closest hit, emission (the env dome's image texture looked
// up here), the diffuse branch and roulette -- bounce_core.cuh's
// bounce(), the same code as the regeneration kernel's. No regeneration,
// no ranks, no depth cap: the caller applies the cap
// (srt_tpu/render/regen_scan.py:126). Out of place, because autograd
// keeps the inputs for the backward kernel.
//
// External-hit mode (n_tris > 0, the template's kExt; bounce.py's
// has_ext): the triangle BVH kernel (intersect_tris.cu) has left each
// lane's closest triangle as (t, u, v, idx). This kernel assembles the
// hit from the triangle tables -- barycentrics (1-u-v, u, v), the
// normalised interpolated normal, the interpolated uv, tri_mat[idx], the
// math of srt_tpu/render/intersect.py:396-403 -- where the JAX package
// gathers in XLA between the two launches, and lets it compete after the
// spheres and rects. With or without triangles the kernel is the rich
// instantiation (kRich) when the scene has any of these families (rich !=
// 0), and lean otherwise: the media sweep (sphere and box media, after the
// triangle hit, as srt_tpu/pallas/bounce.py:1268-1275), the specular
// branch of metal, dielectric and isotropic lanes, checker, marble and
// image textures, sphere lights.
//
// State is (n, 3) rows for o, d, beta, radiance; time float; salt (int32
// bit patterns), depth int32, alive bool. A dead lane passes through with
// depth + 1. With moving spheres (moving != 0, the template's kMoving) a
// lane sees each sphere at its centre at the lane's time; the static
// instantiations do not read the time.
//
// The reference-parity estimator (parity != 0, the template's kParity,
// with every other family): each lane's heap slot starts the bounce at 0
// or 1e30 (parity_slot; 0 under parity_no_stale), the diffuse branch
// draws as bounce_core.cuh's diffuse_parity, and the slot after the
// bounce goes to stale_out, (n,) float32. The incoming stale plane is not
// read, as in the JAX kernel (bounce.py:966-970: the slot does not live
// across bounces). JAX's TPU kernel evaluates every round on every lane
// under masks; here a lane whose pdf turned positive leaves the loop, and
// a round evaluates the stored pdf only where it took the Beckmann BSDF.
//
// Bound: as the regeneration kernel, the shading chain (registers and
// divergence), not bytes: a lane reads 57 B (73 B with a triangle hit)
// and writes 53 B (57 B under parity).
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
  const int* atlas_u32;
  int n, n_sph, n_rect, n_mat, n_light, n_atlas, max_depth, rr_start;
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
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kBlock = 256;

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

template <bool kExt, bool kMoving, bool kRich, bool kParity>
__global__ void __launch_bounds__(kBlock) bounce_kernel(const BounceArgs a) {
  extern __shared__ float smem[];
  SceneView sv = scene_view(a, smem);
  if constexpr (kRich) stage_rich(sv, smem, a);
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  LaneT<float> L;
  L.o = load_row3(a.o, i);
  L.d = load_row3(a.d, i);
  L.beta = load_row3(a.beta, i);
  L.rad = load_row3(a.rad, i);
  const int depth = a.depth[i];
  const float time = kMoving ? a.time[i] : 0.0f;
  // the heap slot, on every lane (the default instantiations have none)
  float slot = 0.0f;
  if constexpr (kParity)
    slot = parity_slot(hash_combine((uint32_t)a.salt[i], (uint32_t)depth),
                       a.parity_no_stale);
  float* const slot_p = kParity ? &slot : nullptr;
  bool alive = false;
  if (a.alive[i]) {
    if constexpr (kExt) {
      const ExtHit e = triangle_hit(a, i);
      alive = bounce<true, kMoving, kRich, kParity>(
          sv, (uint32_t)a.salt[i], depth, time, L, &e, slot_p);
    } else {
      alive = bounce<false, kMoving, kRich, kParity>(
          sv, (uint32_t)a.salt[i], depth, time, L, nullptr, slot_p);
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

template <bool kExt, bool kMoving, bool kRich, bool kParity>
int launch_bounce(const BounceArgs& a, cudaStream_t stream) {
  size_t smem = srt::smem_bytes(a.n_sph, a.n_rect, a.n_mat, a.n_light)
                + (kRich ? srt::rich_smem_bytes(a.perlin) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      bounce_kernel<kExt, kMoving, kRich, kParity>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (a.n + kBlock - 1) / kBlock;
  bounce_kernel<kExt, kMoving, kRich, kParity>
      <<<blocks, kBlock, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kExt, bool kRich, bool kParity>
int launch_moving(const BounceArgs& a, cudaStream_t stream) {
  return a.moving ? launch_bounce<kExt, true, kRich, kParity>(a, stream)
                  : launch_bounce<kExt, false, kRich, kParity>(a, stream);
}

template <bool kExt, bool kRich>
int launch_parity(const BounceArgs& a, cudaStream_t stream) {
  return a.parity ? launch_moving<kExt, kRich, true>(a, stream)
                  : launch_moving<kExt, kRich, false>(a, stream);
}

}  // namespace

extern "C" int srt_bounce(const BounceArgs* args, void* stream) {
  const BounceArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.n_tris > 0)
    return a.rich ? launch_parity<true, true>(a, s)
                  : launch_parity<true, false>(a, s);
  return a.rich ? launch_parity<false, true>(a, s)
                : launch_parity<false, false>(a, s);
}
