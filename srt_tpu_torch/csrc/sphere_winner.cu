// Closest sphere per ray, each ray's sweep split over G threads: kernel B6.
//
// Replaces srt_tpu/pallas/spheres.py:_kernel (launched by
// sphere_winner_pallas), which walks the spheres with a fori_loop over
// (rows, 128) planes and fetches each sphere's fields by a one-hot lane
// sum -- a layout for the TPU's vector memory. Here the (S, 12) sphere
// records of kernels/bounce.py:build_tables are staged in shared memory
// as three float4s a sphere (bounce_core.cuh:stage_spheres; S <= 4096:
// 192 KiB, above the 48 KiB default, so the launch raises the dynamic
// shared-memory limit) and each ray's sweep runs on G threads, its shares,
// as B1's and B2's sweep does (bounce_core.cuh:sphere_share): share p tests
// spheres p, p + G, ... with sphere_t, the test the bounce kernels run, so
// the winner is the sphere B2 shaded, bit for bit. The shares meet in
// nearest_share (the nearest t, the lowest index on a tie), which gives
// the one-thread sweep's first minimum under a strict <.
//
// It returns only (t, idx) per ray, idx -1 on a miss; the caller re-derives
// the hit differentiably from the winner alone (render/intersect.py:
// assemble_sphere_hit), which is how sphere-geometry gradients reach the
// train step's hybrid backward.
//
// Rays are (n, 3) rows o, d and (n,) times; each sphere is at its centre
// at the ray's time (sphere_t<true>, the lerp, which leaves a static
// sphere's centre exactly where it is: c0 + f * 0 == c0).
//
// Bound: 28 B in and 8 B out a ray against about 28 operations a sphere:
// at the train wavefront's 122 spheres the sweep's arithmetic, not memory,
// is the limit, and a sweep is a chain of dependent tests. So the design
// puts more threads on it, as B2 does: 64 rays a block of 64 * G threads,
// share p of every ray in threads p * 64 ... p * 64 + 63, so a warp's
// threads read the same staged sphere at once (a broadcast) and run the
// same number of tests; the shares meet through shared memory and share
// 0 folds them. At the train state's 16,384 rays, one thread a ray in
// 256-thread blocks filled 64 of the card's 132 SMs; 64-ray blocks give
// 256. (A ray's shares on neighbouring lanes meeting by warp shuffles
// measured 3-16% slower on the H100: PERF.md.) The host picks G
// (kernels/bounce.py:sweep_shares, as for B1 and B2). No sphere BVH: the
// JAX package keeps its own off the main path.
#include <cuda_runtime.h>

#include "bounce_core.cuh"

extern "C" {

struct SphereWinnerArgs {
  const float* o;      // (n, 3)
  const float* d;      // (n, 3) unit directions
  const float* time;   // (n,)
  const float* sph;    // (n_sph, 12)
  float* t;            // (n,) kBig on a miss
  int* idx;            // (n,) -1 on a miss
  int n, n_sph;
  float t_min;
  int shares;          // threads a ray, G: 1, 2, 4 or 8
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kRays = 64;   // rays a block

template <int G>
__global__ void __launch_bounds__(kRays * G)
sphere_winner_kernel(const SphereWinnerArgs a) {
  extern __shared__ float4 s_sph[];
  __shared__ float s_t[G][kRays];
  __shared__ int s_k[G][kRays];
  stage_spheres(s_sph, a.sph, a.n_sph);
  __syncthreads();
  const int p = threadIdx.x / kRays, l = threadIdx.x % kRays;
  const int i = blockIdx.x * kRays + l;
  float t = kBig;
  int k = -1;
  if (i < a.n) {
    SceneView s{};
    s.sph = s_sph;
    s.n_sph = a.n_sph;
    sphere_share<true>(s, load_row3(a.o, i), load_row3(a.d, i), a.time[i],
                       p, G, t, k, a.t_min);
  }
  if constexpr (G > 1) {
    s_t[p][l] = t;
    s_k[p][l] = k;
    __syncthreads();
    if (p != 0) return;
    for (int q = 1; q < G; ++q) nearest_share(s_t[q][l], s_k[q][l], t, k);
  }
  if (i < a.n) {
    a.t[i] = t;
    a.idx[i] = k;
  }
}

template <int G>
int launch_winner(const SphereWinnerArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 12 * (size_t)a.n_sph;
  cudaError_t err = cudaFuncSetAttribute(
      sphere_winner_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.n + kRays - 1) / kRays;
  sphere_winner_kernel<G><<<blocks, kRays * G, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int srt_sphere_winner(const SphereWinnerArgs* args,
                                 void* stream) {
  const SphereWinnerArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (a.shares) {
    case 1: return launch_winner<1>(a, s);
    case 2: return launch_winner<2>(a, s);
    case 4: return launch_winner<4>(a, s);
    case 8: return launch_winner<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
