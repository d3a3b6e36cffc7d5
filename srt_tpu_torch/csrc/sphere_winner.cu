// Closest sphere per ray, one thread per ray: kernel B6.
//
// Replaces srt_tpu/pallas/spheres.py:_kernel (launched by
// sphere_winner_pallas), which walks the spheres with a fori_loop over
// (rows, 128) planes and fetches each sphere's fields by a one-hot lane
// sum -- a layout for the TPU's vector memory. Here the (S, 12) sphere
// records of kernels/bounce.py:build_tables are staged in shared memory
// (S <= 4096 under B2's table cap: 192 KiB, above the 48 KiB default, so
// the launch raises the dynamic shared-memory limit) and each thread
// sweeps them for its own ray with bounce_core.cuh's sphere_t, the test
// the bounce kernels' sweep runs: the winner is the sphere B2 shaded, bit
// for bit. Ties keep the lowest index (strict <).
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
// is the limit. The simple design takes the plain sweep (no sphere BVH:
// the JAX package keeps its own off the main path).
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
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
sphere_winner_kernel(const SphereWinnerArgs a) {
  extern __shared__ float s_sph[];
  for (int k = threadIdx.x; k < 12 * a.n_sph; k += kBlock)
    s_sph[k] = a.sph[k];
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const V3 o = load_row3(a.o, i), d = load_row3(a.d, i);
  const float time = a.time[i];
  float t_best = kBig;
  int w = -1;
  for (int k = 0; k < a.n_sph; ++k) {
    const float t = sphere_t<true>(s_sph + 12 * k, o, d, time, a.t_min);
    if (t < t_best) {
      t_best = t;
      w = k;
    }
  }
  a.t[i] = t_best;
  a.idx[i] = w;
}

}  // namespace

extern "C" int srt_sphere_winner(const SphereWinnerArgs* args,
                                 void* stream) {
  const SphereWinnerArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * 12 * (size_t)a.n_sph;
  cudaError_t err = cudaFuncSetAttribute(
      sphere_winner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.n + kBlock - 1) / kBlock;
  sphere_winner_kernel<<<blocks, kBlock, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
