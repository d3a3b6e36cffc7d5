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
//      Lean: parameters 0 and 1 and the colour (5 inputs, 14 columns);
//      the second colour is read by no lean branch. Rich: those and the
//      second colour (8 inputs, 17 columns). Parameters 2 and 3 are read
//      by no branch of the JAX kernel's _shade_core: their cotangents are
//      0. Textures follow what JAX's train step computes:
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
// Each pass of K columns is a thread of its own: thread (lane i, pass p)
// replays lane i's winner and runs the pass of columns p*K .. p*K + K - 1,
// writing those columns and no other, so no two threads write one output
// and there is no reduction. Pass 0 also writes what no column feeds (the
// radiance's cotangent, the zero entries, the material id). Forward mode
// computes each column from its own seed, and every branch reads values,
// never tangents, so a column's operations, and its bits, are those of a
// one-thread kernel running every pass in turn.
//
// Bound: registers and latency. Each Dual<K> value is K + 1 floats and the
// Beckmann chain keeps dozens live; at K = 7 a thread takes 255 registers
// and spills, and a 16,384-lane train state gave one 4-warp block per SM.
// The passes on threads of their own give P times the threads, with a
// Dual of fewer tangents each, so more warps hide each other's latency.
// The price is the winner's sweep replayed by each of a lane's P threads.
// The widths K are chosen by measurement; the column map, the widths and
// the passes are bwd_columns.cuh's.
// The rich instantiation stages the Perlin tables in shared memory as B1
// and B2 do (stage_rich) and reads the media and the lights' kinds from
// global memory.
// The launch sweeps only the live lanes where that spares blocks. Where
// the wavefront's 32-lane tiles fit in the blocks the card holds at once,
// one block a tile, as the sweep over every lane always was (a dead lane
// costs nothing there but its tile's slowest lane). Else one cooperative
// launch, the grid the blocks the card holds at once: each block lists its
// share's live lanes (live_lanes.cuh); after a grid barrier each stages
// the scene tables once and sweeps 32-lane tiles of the list, drawn from
// a counter, then runs of dead lanes, beside the last tiles. A lane's threads run the same code
// on the same inputs whichever lanes share its tile, so its outputs are
// those of a launch over every lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "bounce_core.cuh"
#include "bwd_columns.cuh"
#include "live_lanes.cuh"

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
  const void* atlas;            // texels: packed rgb8, or 3 floats
  int n, n_sph, n_rect, n_mat, n_light, n_atlas, atlas_f32, max_depth,
      rr_start;
  float pdf_floor;
  const float* med;             // (n_med, 10) media (rich)
  int n_med;
  int rich;                     // the rich instantiation (kRich)
  const int* light_kind;        // (n_light,) 0 rect, 1 sphere (rich)
  const float* perlin_vec;      // (256, 3) (rich)
  const int* perlin_perm;       // (3, 256) (rich)
  int perlin;                   // stage the Perlin tables (noise)
  int* list;                    // (n + srt_bounce_bwd_scratch(),) scratch:
                                // the live lanes, each block's count, the
                                // draws of tiles and of runs of dead lanes
  unsigned* barrier;            // (1,) the grid barrier's arrivals, 0 at
                                // first, never reset: one a stream
  long long* live;              // null, or where to add the lanes swept
};

}  // extern "C"

namespace {

using namespace srt;

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

// Jacobian column col of the lane with no shading to differentiate (dead,
// or a miss): the state cotangents pass through, the material columns are 0
__device__ __forceinline__ float pass_through(const Rows& ct, int col) {
  switch (col) {
    case 0: return ct.o.x;
    case 1: return ct.o.y;
    case 2: return ct.o.z;
    case 3: return ct.d.x;
    case 4: return ct.d.y;
    case 5: return ct.d.z;
    case 6: return ct.beta.x;
    case 7: return ct.beta.y;
    case 8: return ct.beta.z;
    default: return 0.0f;
  }
}

using bwd::kPasses;

// Lanes a block; each of a lane's passes is a warp of the block
constexpr int kLanes = 32;

// Thread (lane i, pass p) of one 32-lane tile: columns p*K .. p*K + K - 1
// of lane i's Jacobian, where the lane is one of the tile's (``on``); a
// dead lane (``live`` false) passes its cotangents through. A lane's P
// threads share its closest-hit replay: each sweeps every P-th sphere
// (bounce_core.cuh:sphere_share, as B1 and B2 split theirs) and they
// exchange their bests through shared memory. Every thread of the block
// calls it; it meets them twice, and returns ``*next`` (0 if null), read
// between the two meetings.
template <int K, bool kRich>
__device__ __forceinline__ int sweep_tile(const BounceBwdArgs& a,
                                          const SceneView& sv, int i,
                                          bool on, bool live,
                                          const int* next) {
  constexpr int P = kPasses<K, kRich>;
  __shared__ float share_t[P][kLanes];
  __shared__ int share_k[P][kLanes];
  const int p = threadIdx.x / kLanes, l = threadIdx.x % kLanes;
  Rows in, ct;
  if (on) {
    in = load_rows(a.o, a.d, a.beta, a.rad, i);
    ct = load_rows(a.ct_o, a.ct_d, a.ct_beta, a.ct_rad, i);
  }
  __syncthreads();   // the tables staged, the last tile's shares read
  const int nxt = next != nullptr ? *next : 0;
  float t_sph = kBig;
  int k_sph = -1;
  if (live) sphere_share<false>(sv, in.o, in.d, 0.0f, p, P, t_sph, k_sph);
  share_t[p][l] = t_sph;
  share_k[p][l] = k_sph;
  __syncthreads();
  if (!on) return nxt;
  const int base = p * K;

  Contracted<K> c;
#pragma unroll
  for (int k = 0; k < K; ++k) c.g[k] = pass_through(ct, base + k);
  int m = 0;
  if (live) {
    // the nearest of the shares, the lowest index on a tie
    for (int q = 0; q < P; ++q)
      nearest_share(share_t[q][l], share_k[q][l], t_sph, k_sph);
    Winner W = finish_hit(sv, in.o, in.d, t_sph, k_sph);
    const int depth = a.depth[i];
    const uint32_t salt = hash_combine((uint32_t)a.salt[i],
                                       (uint32_t)depth);
    if constexpr (kRich) take_media(W, sv.med, sv.n_med, in.o, in.d, salt);
    if (W.hit) {
      m = W.m;
      c = vjp_pass<K, kRich>(sv, W, salt, depth, in, ct, base);
    }
  }
  bwd::store_pass<K, kRich>(bwd::Grads{a.g_o, a.g_d, a.g_beta, a.g_mat}, i,
                            p, c.g);
  if (p == 0) {   // what no column feeds
    store_row3(a.g_rad, i, ct.rad);
    bwd::store_unfed<kRich>(a.g_mat, i);
    a.wmat[i] = m;
  }
  return nxt;
}

// A launch over the lanes (kList false): block b sweeps lanes 32b ..
// 32b + 31, each block staging the tables. A launch over the list (kList,
// cooperative, the grid the blocks the card holds at once): the list
// (live_lanes.cuh); each block stages the tables once and sweeps 32-lane
// tiles of the list, tile blockIdx.x first, then the next one no block has
// taken (a counter), so blocks that drew slow tiles take fewer; then the
// blocks draw runs of dead lanes and write their outputs, beside the last
// tiles. The rich instantiation is held to two blocks an SM (168
// registers; left free, it takes 182 over the lanes and 198-205 over the
// list, and one block).
template <int K, bool kRich, bool kList>
__global__ void __launch_bounds__((kLanes * kPasses<K, kRich>),
                                  kRich ? 2 : 1)
bounce_bwd_kernel(const __grid_constant__ BounceBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int l = threadIdx.x % kLanes;
  if constexpr (!kList) {
    SceneView sv = scene_view(a, smem);
    if constexpr (kRich) stage_rich(sv, smem, a);
    const int i = blockIdx.x * kLanes + l;
    const bool is_live = i < a.n && a.alive[i];
    if (a.live != nullptr) {
      const int c = __syncthreads_count(is_live && threadIdx.x < kLanes);
      if (threadIdx.x == 0 && c > 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.live),
                  (unsigned long long)c);
    }
    sweep_tile<K, kRich>(a, sv, i, i < a.n, is_live, nullptr);
  } else {
    __shared__ int next;
    int* const counts = a.list + a.n;
    int* const draws = counts + live::kMaxBlocks;   // tiles, dead runs
    // tiles 0 .. gridDim.x - 1 go by block index; the grid barrier in
    // list_live orders this before any draw
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      draws[0] = gridDim.x;
      draws[1] = 0;
    }
    const live::Lanes lanes{a.alive, a.n, a.list, counts, a.barrier, a.live};
    const int total = live::list_live(lanes);
    if (total > 0) {
      SceneView sv = scene_view(a, smem);
      if constexpr (kRich) stage_rich(sv, smem, a);
      grid_barrier(a.barrier);   // the list whole, the tables staged
      const int tiles = (total + kLanes - 1) / kLanes;
      for (int tile = blockIdx.x; tile < tiles;) {
        if (threadIdx.x == 0) next = atomicAdd(draws, 1);
        const int slot = tile * kLanes + l;
        const bool on = slot < total;
        tile = sweep_tile<K, kRich>(a, sv, on ? __ldcg(a.list + slot) : 0,
                                    on, on, &next);
      }
    }
    live::pass_dead(lanes,
                    live::PassThrough{{a.ct_o, a.ct_d, a.ct_beta, a.ct_rad},
                                      {a.g_o, a.g_d, a.g_beta, a.g_rad},
                                      a.g_mat, a.wmat},
                    draws + 1);
  }
}

// The blocks of a launch of bounce_bwd_kernel<K, kRich, kList> the card
// holds at once with ``smem`` bytes of dynamic shared memory, found once
// for each device and size; the kernel's dynamic shared memory limit is
// raised to the largest size yet asked for on the device. A negative
// cudaError_t if a query failed.
template <bool kRich, bool kList>
int resident_blocks(size_t smem) {
  constexpr int K = bwd::kWidth<kRich>;
  constexpr int kThreads = kLanes * kPasses<K, kRich>;
  struct Known {
    int dev;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Known> known, limit;   // limit: .smem set by device
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  std::lock_guard<std::mutex> hold(mu);
  for (const Known& k : known)
    if (k.dev == dev && k.smem == smem) return k.blocks;
  Known* lim = nullptr;
  for (Known& k : limit)
    if (k.dev == dev) lim = &k;
  if (lim == nullptr || lim->smem < smem) {
    err = cudaFuncSetAttribute(bounce_bwd_kernel<K, kRich, kList>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return -(int)err;
    if (lim == nullptr) limit.push_back(Known{dev, smem, 0});
    else lim->smem = smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bounce_bwd_kernel<K, kRich, kList>, kThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  known.push_back(Known{dev, smem, per_sm * sms});
  return per_sm * sms;
}

// Over the lanes where their tiles fit in the blocks the card holds at
// once (a list would spare no wave of blocks), else over the list.
template <bool kRich>
int launch(const BounceBwdArgs& a, cudaStream_t stream) {
  constexpr int K = bwd::kWidth<kRich>;
  constexpr int kThreads = kLanes * kPasses<K, kRich>;
  const size_t smem = srt::smem_bytes(a.n_sph, a.n_rect, a.n_mat, a.n_light)
                      + (kRich ? srt::rich_smem_bytes(a.perlin) : 0);
  const int tiles = (a.n + kLanes - 1) / kLanes;
  const int held = resident_blocks<kRich, false>(smem);
  if (held < 0) return -held;
  if (tiles <= held) {
    bounce_bwd_kernel<K, kRich, false><<<tiles, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int resident = resident_blocks<kRich, true>(smem);
  if (resident < 0) return -resident;
  if (resident == 0) return (int)cudaErrorLaunchOutOfResources;
  int grid = tiles < resident ? tiles : resident;
  if (grid > live::kMaxBlocks) grid = live::kMaxBlocks;
  void* params[] = {const_cast<BounceBwdArgs*>(&a)};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)bounce_bwd_kernel<K, kRich, true>, dim3(grid),
      dim3(kThreads), params, smem, stream);
}

}  // namespace

extern "C" int srt_bounce_bwd(const BounceBwdArgs* args, void* stream) {
  const BounceBwdArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return a.rich ? launch<true>(a, s) : launch<false>(a, s);
}

// The ints of the launch's scratch past the list of live lanes
extern "C" int srt_bounce_bwd_scratch() { return srt::live::kMaxBlocks + 2; }

// The passes (threads a lane) of the lean (rich 0) or the rich
// instantiation, as compiled
extern "C" int srt_bounce_bwd_passes(int rich) {
  using namespace srt::bwd;
  return rich ? kPasses<kWidth<true>, true> : kPasses<kWidth<false>, false>;
}
