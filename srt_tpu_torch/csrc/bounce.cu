// One bounce of an explicit wavefront state, one thread per lane: the
// forward of the train step.
//
// Replaces srt_tpu/pallas/bounce.py:_kernel in its per-bounce mode
// (regen=False, launched by fused_bounce), without the external
// triangle-hit planes (has_ext) and the parity stale plane, which come
// with the triangle and parity slices. For every lane: closest hit,
// emission (the env dome's image texture looked up here), the diffuse
// branch and roulette -- bounce_core.cuh's bounce(), the same code as the
// regeneration kernel's. No regeneration, no ranks, no depth cap: the
// caller applies the cap (srt_tpu/render/regen_scan.py:126). Out of place,
// because autograd keeps the inputs for the backward kernel.
//
// State is (n, 3) rows for o, d, beta, radiance; salt (int32 bit
// patterns), depth int32, alive bool. A dead lane passes through with
// depth + 1. Time is not read: moving spheres are outside the slice.
//
// Bound: as the regeneration kernel, the shading chain (registers and
// divergence), not bytes: a lane reads 57 B and writes 53 B.
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
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) bounce_kernel(const BounceArgs a) {
  extern __shared__ float smem[];
  const SceneView sv = scene_view(a, smem);
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  LaneT<float> L;
  L.o = load_row3(a.o, i);
  L.d = load_row3(a.d, i);
  L.beta = load_row3(a.beta, i);
  L.rad = load_row3(a.rad, i);
  const int depth = a.depth[i];
  bool alive = false;
  if (a.alive[i]) alive = bounce(sv, (uint32_t)a.salt[i], depth, L);
  store_row3(a.o_out, i, L.o);
  store_row3(a.d_out, i, L.d);
  store_row3(a.beta_out, i, L.beta);
  store_row3(a.rad_out, i, L.rad);
  a.depth_out[i] = depth + 1;
  a.alive_out[i] = alive ? 1 : 0;
}

}  // namespace

extern "C" int srt_bounce(const BounceArgs* args, void* stream) {
  const BounceArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  size_t smem = srt::smem_bytes(a.n_sph, a.n_rect, a.n_mat, a.n_light);
  cudaError_t err = cudaFuncSetAttribute(
      bounce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (a.n + kBlock - 1) / kBlock;
  bounce_kernel<<<blocks, kBlock, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
