// One bounce of the regeneration engine's wavefront, one thread per lane.
//
// Replaces srt_tpu/pallas/bounce.py:_kernel in its regen=True mode
// (launched by fused_regen_bounce). Each launch, for every lane:
//   1. a dead lane takes the next (pixel, sample) work item and becomes a
//      fresh camera ray (Sobol pixel jitter, thin lens, sampler salt);
//   2. closest hit over the spheres (env domes hit at the far root) and
//      the axis-aligned rects;
//   3. emission (the env dome's image texture is looked up here, where
//      the JAX package defers it to an XLA epilogue);
//   4. the diffuse branch: Beckmann VNDF or cosine-lobe BSDF sample mixed
//      50/50 with a rect-light sample, the mixture pdf, the BSDF weight,
//      roulette and the depth cap.
// Steps 2-4 are bounce_core.cuh's bounce(), shared with bounce.cu and
// bounce_bwd.cu. The arithmetic follows the plain PyTorch version
// (srt_tpu_torch/kernels/bounce.py:regen_bounce_reference) operation by
// operation, in the same order, so the two differ only by libm ulps.
// Build without --use_fast_math and with --fmad=false for that reason.
//
// Work-queue ranks are deterministic and equal the plain version's
// torch.cumsum ranks: block b's first rank is the cursor plus the dead
// lanes of blocks 0..b-1 at the end of the previous launch (dead_in[],
// written by that launch), plus an in-block scan. Block 0 writes the new
// cursor; every block writes its own dead count to dead_out[].
//
// Bound: registers and warp divergence in the shading chain (up to nine
// Newton-bisection rounds of erfinv on Beckmann lanes next to Oren-Nayar
// and emitter lanes), not bytes: a lane moves ~80 B of state per bounce.
// Scene tables live in shared memory; dead and emitter-hit lanes skip
// the shading work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_core.cuh"

extern "C" {

struct RegenArgs {
  float* o;            // (3, n) ray origins
  float* d;            // (3, n) unit directions
  float* time;         // (n,)
  float* beta;         // (3, n) throughput
  float* rad;          // (3, n) radiance
  int* salt;           // (n,) 32-bit sampler words (bit patterns)
  int* depth;          // (n,)
  int* alive;          // (n,) 0/1
  int* pix;            // (n,)
  int* fin;            // (n,) out: lane finished its path this bounce
  const int* dead_in;  // (blocks,) dead lanes per block, previous launch
  int* dead_out;       // (blocks,) dead lanes per block after this launch
  const int* cursor_in;
  int* cursor_out;
  const float* sph;    // (n_sph, 12)
  const float* rect;   // (n_rect, 10)
  const float* mat;    // (n_mat, 14)
  const float* light;  // (n_light, 8) rect lights
  const int* tex_img;  // (n_tex, 3) atlas offset, nx, ny
  const int* atlas_u32;
  const float* cam;    // (21,)
  const float* jitter; // (spp, 2)
  int n, n_sph, n_rect, n_mat, n_light, n_atlas;
  int width, height, spp, total_work, max_depth, rr_start;
  float pdf_floor;
  unsigned int seed;
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ V3 load3(const float* p, int n, int i) {
  return v3(p[i], p[n + i], p[2 * n + i]);
}
__device__ __forceinline__ void store3(float* p, int n, int i, V3 a) {
  p[i] = a.x;
  p[n + i] = a.y;
  p[2 * n + i] = a.z;
}

// ---- block-wide helpers --------------------------------------------------
__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kBlock)
regen_bounce_kernel(const RegenArgs a) {
  extern __shared__ float smem[];
  __shared__ int s_part[2][kWarps];
  __shared__ int s_warp_dead[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kBlock + tid;
  const bool valid = i < a.n;
  const SceneView sv = scene_view(a, smem);

  // work-queue rank of each dead lane: dead lanes of earlier blocks (as
  // the previous launch left them), then the in-block exclusive scan
  const bool was_alive = valid && a.alive[i] != 0;
  const bool need = valid && !was_alive;
  const int n_blocks = gridDim.x;
  int before = 0, total = 0;
  for (int k = tid; k < n_blocks; k += kBlock) {
    int v = a.dead_in[k];
    total += v;
    if (k < (int)blockIdx.x) before += v;
  }
  before = warp_sum(before);
  total = warp_sum(total);
  const unsigned need_bits = __ballot_sync(0xffffffffu, need);
  if (lane == 0) {
    s_part[0][warp] = before;
    s_part[1][warp] = total;
    s_warp_dead[warp] = __popc(need_bits);
  }
  __syncthreads();
  const int cursor = a.cursor_in[0];
  int rank = __popc(need_bits & ((1u << lane) - 1u));
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    rank += s_part[0][w] + (w < warp ? s_warp_dead[w] : 0);
    total += s_part[1][w];
  }
  if (blockIdx.x == 0 && tid == 0)
    a.cursor_out[0] = cursor + min(total, max(a.total_work - cursor, 0));

  bool alive_fin = false;
  if (valid) {
    LaneT<float> L;
    int depth = a.depth[i];
    float time = 0.0f;
    uint32_t salt = 0u;
    int pix = a.pix[i];
    const int wid = cursor + rank;
    const bool take = need && wid < a.total_work;
    bool live = was_alive;
    if (take) {
      // a fresh camera ray for work item wid (sample-minor)
      const int pixn = wid / a.spp, sampn = wid % a.spp;
      const float* cam = a.cam;
      float col = (float)(pixn % a.width), row = (float)(pixn / a.width);
      float s = (col + a.jitter[2 * sampn]) / (float)a.width;
      float t = ((float)a.height - 1.0f - row + a.jitter[2 * sampn + 1])
                / (float)a.height;
      uint32_t salt_new = hash_combine((uint32_t)pixn,
                                       hash_combine((uint32_t)sampn, a.seed));
      float r = cam[18] * sqrtf(uniform(salt_new, 32));
      float phi = kTwoPi * uniform(salt_new, 33);
      float rc = r * cosf(phi), rs = r * sinf(phi);
      V3 off = v3(cam[12] * rc + cam[15] * rs, cam[13] * rc + cam[16] * rs,
                  cam[14] * rc + cam[17] * rs);
      V3 org = v3(cam[0], cam[1], cam[2]);
      L.o = add(org, off);
      L.d = normalize(v3(
          cam[3] + s * cam[6] + t * cam[9] - cam[0] - off.x,
          cam[4] + s * cam[7] + t * cam[10] - cam[1] - off.y,
          cam[5] + s * cam[8] + t * cam[11] - cam[2] - off.z));
      time = cam[19] + uniform(salt_new, 34) * (cam[20] - cam[19]);
      L.beta = v3(1.0f, 1.0f, 1.0f);
      L.rad = v3(0.0f, 0.0f, 0.0f);
      salt = salt_new;
      depth = 0;
      pix = pixn;
      live = true;
    } else if (live) {
      L.o = load3(a.o, a.n, i);
      L.d = load3(a.d, a.n, i);
      L.beta = load3(a.beta, a.n, i);
      L.rad = load3(a.rad, a.n, i);
      time = a.time[i];
      salt = (uint32_t)a.salt[i];
    }
    if (live) {
      bool alive_next = bounce(sv, salt, depth, L);
      alive_fin = alive_next && depth + 1 < a.max_depth;
      store3(a.o, a.n, i, L.o);
      store3(a.d, a.n, i, L.d);
      store3(a.beta, a.n, i, L.beta);
      store3(a.rad, a.n, i, L.rad);
      if (take) {
        a.time[i] = time;
        a.salt[i] = (int)salt;
        a.pix[i] = pix;
      }
    }
    a.depth[i] = depth + 1;
    a.alive[i] = alive_fin ? 1 : 0;
    a.fin[i] = (live && !alive_fin) ? 1 : 0;
  }

  // this block's dead lanes, for the next launch's ranks
  const unsigned dead_bits = __ballot_sync(0xffffffffu, valid && !alive_fin);
  __syncthreads();   // s_warp_dead was read above
  if (lane == 0) s_warp_dead[warp] = __popc(dead_bits);
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += s_warp_dead[w];
    a.dead_out[blockIdx.x] = sum;
  }
}

}  // namespace

extern "C" int srt_regen_bounce(const RegenArgs* args, void* stream) {
  const RegenArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  size_t smem = srt::smem_bytes(a.n_sph, a.n_rect, a.n_mat, a.n_light);
  cudaError_t err = cudaFuncSetAttribute(
      regen_bounce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (a.n + kBlock - 1) / kBlock;
  regen_bounce_kernel<<<blocks, kBlock, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* srt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
