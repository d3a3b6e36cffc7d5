// One bounce of the regeneration engine's wavefront: a block of lanes, G
// threads a lane for its sphere sweep and one for the rest.
//
// Replaces srt_tpu/pallas/bounce.py:_kernel in its regen=True mode
// (launched by fused_regen_bounce). Each launch, for every lane:
//   1. a dead lane takes the next (pixel, sample) work item and becomes a
//      fresh camera ray (Sobol pixel jitter, thin lens, sampler salt);
//   2. closest hit over the spheres (env domes hit at the far root; with
//      moving != 0, the template's kMoving, each sphere at its centre at
//      the lane's time) and the axis-aligned rects;
//   3. emission (the env dome's image texture is looked up here, where
//      the JAX package defers it to an XLA epilogue);
//   4. the diffuse branch: Beckmann VNDF or cosine-lobe BSDF sample mixed
//      50/50 with a light sample, the mixture pdf, the BSDF weight,
//      roulette and the depth cap.
// Step 2's sphere sweep is bounce_core.cuh's sphere_share, split over the
// lane's threads; the rest of steps 2-4 is bounce(), shared with
// bounce.cu (bounce_bwd.cu replays the same sweep and shading). With rich
// != 0 (the template's kRich) the kernel is the rich instantiation: after
// the closest hit the media sweep, then the specular branch of metal,
// dielectric and isotropic lanes, checker, marble and image textures on
// every material (the Perlin tables staged in shared memory after the
// scene tables), and sphere lights; the lean instantiations (ball_scenes)
// compile without any of it. The arithmetic follows the plain PyTorch
// version (srt_tpu_torch/kernels/bounce.py:regen_bounce_reference)
// operation by operation, in the same order, so the two differ only by
// libm ulps.
// Build without --use_fast_math and with --fmad=false for that reason.
//
// Layout: a block holds kLanes lanes and G threads a lane, the lane's
// shares (template G: 1, 2, 4 or 8, picked on the host from the lane count
// and the spheres, kernels/bounce.py:sweep_shares). Share p is threads
// p*kLanes .. p*kLanes + kLanes - 1, whole warps. Share 0 holds the lanes:
// it takes the work, sets up the ray (a fresh camera ray or the lane's
// state) and hands it to the other shares through shared memory; each
// share sweeps every G-th sphere (bounce_core.cuh:sphere_share), and share
// 0 combines the shares (nearest_share) and runs the rect sweep, the media
// sweep and the whole shading on one warp per 32 lanes, so the shading
// keeps full warps. The winner is closest_hit's, so the bits are the
// one-thread kernel's.
//
// Work-queue ranks are deterministic and equal the plain version's
// torch.cumsum ranks: block b's first rank is the cursor plus the dead
// lanes of blocks 0..b-1 at the end of the previous launch (dead_in[],
// written by that launch), plus an in-block scan over share 0's warps.
// Every thread of the block reads a slice of dead_in[]; block 0 writes
// the new cursor; every block writes its own dead count to dead_out[].
// kLanes is kernels/bounce.py's BLOCK: the dead counts are per kLanes
// lanes.
//
// Bound: instructions and latency. The sphere sweep is most of a lane's
// operations (122 spheres on ball_scenes, 484 moving ones on
// random_scene), one dependent chain a thread: the shares split it over
// G threads, and the staged records (stage_spheres) make a test one
// 16-byte shared load and skip the square root on lanes that miss. The
// shading chain then runs one thread a lane with its divergence (up to
// nine Newton-bisection rounds of erfinv on Beckmann lanes next to
// Oren-Nayar and emitter lanes), and on ball_scenes it takes about half
// the time; not bytes: a lane moves ~80 B of state per bounce. The rich
// instantiation adds divergence: a dielectric or metal lane beside a
// diffuse one, and seven octaves of eight Perlin corners on the few lanes
// that hit a marble.
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
  int moving;          // spheres move over the shutter interval
  const float* med;    // (n_med, 10) media (rich)
  int n_med;
  int rich;            // the rich instantiation (kRich)
  const int* light_kind;     // (n_light,) 0 rect, 1 sphere (rich)
  const float* perlin_vec;   // (256, 3) (rich)
  const int* perlin_perm;    // (3, 256) (rich)
  int perlin;          // stage the Perlin tables (a noise texture)
  int shares;          // threads a lane, G: 1, 2, 4 or 8
};

}  // extern "C"

namespace {

using namespace srt;

constexpr int kLanes = 128;   // lanes a block (kernels/bounce.py:BLOCK)
constexpr int kLaneWarps = kLanes / 32;

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

template <bool kMoving, bool kRich, int G>
__global__ void __launch_bounds__(kLanes * G)
regen_bounce_kernel(const RegenArgs a) {
  constexpr int kWarps = kLanes * G / 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_part[2][kWarps];
  __shared__ int s_warp_dead[kLaneWarps];
  // G > 1: each live lane's ray for the shares, and the shares' winners
  __shared__ float s_ray[7][G > 1 ? kLanes : 1];
  __shared__ float s_share_t[G][kLanes];
  __shared__ int s_share_k[G][kLanes];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = tid / kLanes, l = tid % kLanes;
  const bool lead = p == 0;   // share 0 holds the lanes
  const int i = blockIdx.x * kLanes + l;
  const bool valid = i < a.n;
  SceneView sv = scene_view(a, smem);
  if constexpr (kRich) stage_rich(sv, smem, a);

  // work-queue rank of each dead lane: dead lanes of earlier blocks (as
  // the previous launch left them), then the in-block exclusive scan
  const bool was_alive = lead && valid && a.alive[i] != 0;
  const bool need = lead && valid && !was_alive;
  const int n_blocks = gridDim.x;
  int before = 0, total = 0;
  for (int k = tid; k < n_blocks; k += kLanes * G) {
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
    if (lead) s_warp_dead[warp] = __popc(need_bits);
  }
  __syncthreads();
  const int cursor = a.cursor_in[0];
  int rank = __popc(need_bits & ((1u << lane) - 1u));
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    rank += s_part[0][w] + (w < warp && w < kLaneWarps ? s_warp_dead[w] : 0);
    total += s_part[1][w];
  }
  if (blockIdx.x == 0 && tid == 0)
    a.cursor_out[0] = cursor + min(total, max(a.total_work - cursor, 0));

  // share 0 sets up its lane's ray
  LaneT<float> L;
  int depth = 0, pix = 0;
  float time = 0.0f;
  uint32_t salt = 0u;
  bool take = false, live = false;
  if (lead && valid) {
    depth = a.depth[i];
    pix = a.pix[i];
    const int wid = cursor + rank;
    take = need && wid < a.total_work;
    live = was_alive;
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
  }

  // the sphere sweep, split over the lane's G shares
  float t_sph = kBig;
  int k_sph = -1;
  if constexpr (G == 1) {
    if (live) sphere_share<kMoving>(sv, L.o, L.d, time, 0, 1, t_sph, k_sph);
  } else {
    if (lead) {
      s_ray[0][l] = live ? L.o.x : __int_as_float(0x7fc00000);  // NaN: none
      s_ray[1][l] = L.o.y;
      s_ray[2][l] = L.o.z;
      s_ray[3][l] = L.d.x;
      s_ray[4][l] = L.d.y;
      s_ray[5][l] = L.d.z;
      s_ray[6][l] = time;
    }
    __syncthreads();
    const V3 o = v3(s_ray[0][l], s_ray[1][l], s_ray[2][l]);
    if (!isnan(o.x))
      sphere_share<kMoving>(sv, o, v3(s_ray[3][l], s_ray[4][l], s_ray[5][l]),
                            s_ray[6][l], p, G, t_sph, k_sph);
    s_share_t[p][l] = t_sph;
    s_share_k[p][l] = k_sph;
    __syncthreads();
    if (lead)
      for (int q = 1; q < G; ++q)
        nearest_share(s_share_t[q][l], s_share_k[q][l], t_sph, k_sph);
  }

  // share 0 shades its lane
  bool alive_fin = false;
  if (lead && valid) {
    if (live) {
      bool alive_next = bounce<false, kMoving, kRich>(sv, salt, depth, time,
                                                      L, t_sph, k_sph);
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
  const unsigned dead_bits = __ballot_sync(0xffffffffu,
                                           lead && valid && !alive_fin);
  __syncthreads();   // s_warp_dead was read above
  if (lane == 0 && lead) s_warp_dead[warp] = __popc(dead_bits);
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int w = 0; w < kLaneWarps; ++w) sum += s_warp_dead[w];
    a.dead_out[blockIdx.x] = sum;
  }
}

template <bool kMoving, bool kRich, int G>
int launch_regen(const RegenArgs& a, cudaStream_t stream) {
  size_t smem = srt::smem_bytes(a.n_sph, a.n_rect, a.n_mat, a.n_light)
                + (kRich ? srt::rich_smem_bytes(a.perlin) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      regen_bounce_kernel<kMoving, kRich, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (a.n + kLanes - 1) / kLanes;
  regen_bounce_kernel<kMoving, kRich, G>
      <<<blocks, kLanes * G, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kMoving, bool kRich>
int launch_shares(const RegenArgs& a, cudaStream_t stream) {
  switch (a.shares) {
    case 1: return launch_regen<kMoving, kRich, 1>(a, stream);
    case 2: return launch_regen<kMoving, kRich, 2>(a, stream);
    case 4: return launch_regen<kMoving, kRich, 4>(a, stream);
    case 8: return launch_regen<kMoving, kRich, 8>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int srt_regen_bounce(const RegenArgs* args, void* stream) {
  const RegenArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.rich)
    return a.moving ? launch_shares<true, true>(a, s)
                    : launch_shares<false, true>(a, s);
  return a.moving ? launch_shares<true, false>(a, s)
                  : launch_shares<false, false>(a, s);
}

extern "C" const char* srt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
