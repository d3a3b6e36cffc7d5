// The film sum of the regeneration engine: each finished lane's NaN-scrubbed
// radiance added into its pixel's (3,) sum, the lanes of a pixel in lane
// order, starting from the pixel's current sum; and the counts of live
// lanes (traced path vertices) and of scrubbed NaN components.
//
// Replaces no TPU kernel. The JAX package adds the finished lanes outside
// its Pallas kernel with XLA's scatter (srt_tpu/render/regen.py:117,
// acc.at[pix].add(contrib)), whose sums come out the same every run. The
// port's index_add_ does it on the card with float atomics, in an order the
// scheduler picks, so two renders of one scene differed in their last bits
// (ROADMAP C18). This kernel gives the sums of index_add_ on the CPU, which
// adds lane after lane: the same bits on the same inputs.
//
// One cooperative launch, two phases around one grid barrier. The lanes
// are cut into tiles of kThreads, one block's worth:
//  1. every lane counts itself if live and its finished NaN components
//     (integer atomics, one a block: their order changes no count). In each
//     tile the finished lanes of one pixel find each other (warp match,
//     then ballots over the tile's earlier warps in shared memory) and make
//     one record: their scrubbed radiance packed in lane order into the
//     tile's stretch of a scratch buffer (a block scan places the records),
//     its place and length stored at the record's first lane, which pushes
//     the record on its pixel's chain, next[i] = atomicExch(&head[pix], i),
//     in whatever order tiles come;
//  2. the record at the end of its pixel's chain (the first pushed: one a
//     pixel) walks the chain, marks each record's tile in a bitmap (kWindow
//     tiles at a time, one walk a window), adds the records in tile order,
//     each one's packed lanes in order, and sets head[pix] back to -1 for
//     the next launch.
// A pixel's records are the tiles its finished lanes lie in: one or two for
// a pixel's 16 samples on the main path, four for the 1,024 camera rays of
// a pixel that finish together (work is handed out pixel-major), up to a
// few hundred for 1,024 samples that scatter over the wavefront. The serial
// work a pixel: a dependent load a record on the walk, two loads a record
// and one add a lane; the lanes' loads are 16 at a time.
//
// Bound: the bytes. Every lane reads its two masks (8 B); a finished lane
// its pixel (4 B) and radiance (12 B); each touched pixel's sums are read
// and written once (24 B). Two float adds a finished lane's channel: far
// below the card's rate. What the design does about it: one pass over the
// lanes, no sort of the whole wavefront, one launch where the torch flush
// took about eight.
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

struct FilmSumArgs {
  float* acc;              // (3, pixels): the image sums, updated in place
  const int* pix;          // (n,) each lane's pixel
  const float* rad;        // (3, n) each lane's radiance
  const int* fin;          // (n,) finished in this bounce
  const int* alive;        // (n,) alive after it
  int* head;               // (pixels,) each pixel's chain, -1 between launches
  int* next;               // (n,) the chains' links, at each record's lane
  int* rec;                // (n, 2) each record's place and length in packed
  float* packed;           // (n, 3) the records' scrubbed radiance
  unsigned* barrier;       // (2,) arrivals, generation; arrivals 0 between launches
  long long* n_vertices;   // () += live lanes
  long long* nan_scrubbed; // () += NaN components of finished lanes
  int n, pixels;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 256;   // tiles a walk of a chain places
constexpr int kBatch = 16;     // lanes of a record loaded at once
constexpr unsigned kAll = 0xffffffffu;
// next[] of a finished lane that heads no record
constexpr int kNoRecord = -2;

// every block of the grid meets here; the launch is cooperative, so all of
// them are resident. The arrivals go back to 0 for the next launch.
__device__ void grid_barrier(unsigned* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ unsigned block_sum(unsigned v, unsigned* s_warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kAll, v, o);
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = v;
  __syncthreads();
  unsigned t = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += s_warp[w];
  __syncthreads();
  return t;
}

// the sum of v over the block's earlier threads
__device__ int block_exclusive_scan(int v, unsigned* s_warp) {
  const int l = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, x, o);
    if (l >= o) x += y;
  }
  if (l == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  __syncthreads();
  return before + x - v;
}

// the record at lane j: its packed lanes, in order, added to the sums s
__device__ __forceinline__ void add_record(const FilmSumArgs& a, int j,
                                           float* s) {
  const int2 r = __ldcg(reinterpret_cast<const int2*>(a.rec) + j);
  const float* v0 = a.packed + (long long)r.x * 3;
  for (int q0 = 0; q0 < r.y; q0 += kBatch) {
    float v[kBatch * 3];
#pragma unroll
    for (int e = 0; e < kBatch * 3; ++e)
      v[e] = q0 * 3 + e < r.y * 3 ? __ldcg(v0 + q0 * 3 + e) : 0.0f;
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (q0 + q < r.y)
#pragma unroll
        for (int c = 0; c < 3; ++c) s[c] += v[q * 3 + c];
  }
}

__global__ void __launch_bounds__(kThreads, 2) film_sum_kernel(
    const FilmSumArgs a) {
  __shared__ unsigned s_warp[kWarps];
  __shared__ int s_pix[kThreads];
  __shared__ int s_off[kThreads];
  __shared__ unsigned s_bits[kThreads * kWarps];
  const int tiles = (a.n + kThreads - 1) / kThreads;
  const int t_id = threadIdx.x, warp = t_id / 32, l = t_id % 32;

  // 1. counts, and each tile's finished lanes of a pixel as one record on
  //    the pixel's chain
  unsigned live = 0, nans = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int base = t * kThreads, i = base + t_id;
    const bool fin = i < a.n && a.fin[i] != 0;
    live += i < a.n && (fin || a.alive[i] != 0);
    const int p = fin ? a.pix[i] : -1;
    float r[3] = {0.0f, 0.0f, 0.0f};
    if (fin) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = a.rad[(long long)c * a.n + i];
        nans += isnan(v);
        r[c] = isnan(v) ? 0.0f : v;
      }
    }
    s_pix[t_id] = p;
#pragma unroll
    for (int e = 0; e < kWarps; ++e) s_bits[e * kThreads + t_id] = 0u;
    __syncthreads();

    // the warp's lanes of one pixel; its first lane looks for the pixel
    // in the tile's earlier warps (the record's first lane, lead), one
    // ballot a pending pixel and warp
    const unsigned same = __match_any_sync(kAll, p);
    const bool first = fin && (int)(__ffs(same) - 1) == l;
    int lead = t_id;
    unsigned pending = __ballot_sync(kAll, first);
    for (int w = 0; w < warp && pending; ++w) {
      const int q = s_pix[w * 32 + l];
      for (unsigned b = pending; b; b &= b - 1) {
        const int j = __ffs(b) - 1;
        const unsigned hit = __ballot_sync(kAll, q == __shfl_sync(kAll, p, j));
        if (hit) {
          if (l == j) lead = w * 32 + __ffs(hit) - 1;
          pending &= ~(1u << j);
        }
      }
    }
    const bool heads = first && lead == t_id;
    lead = __shfl_sync(kAll, lead, __ffs(same) - 1);
    if (first) s_bits[lead * kWarps + warp] = same;
    __syncthreads();

    // each record's place in the tile's stretch of packed, in lane order
    int count = 0;
    if (heads)
#pragma unroll
      for (int w = 0; w < kWarps; ++w) count += __popc(s_bits[t_id * kWarps + w]);
    const int off = block_exclusive_scan(count, s_warp);
    if (heads) s_off[t_id] = off;
    __syncthreads();

    if (fin) {
      int rank = __popc(same & ((1u << l) - 1u));
      for (int w = 0; w < warp; ++w) rank += __popc(s_bits[lead * kWarps + w]);
      float* dst = a.packed + (long long)(base + s_off[lead] + rank) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[c] = r[c];
      if (heads) {
        reinterpret_cast<int2*>(a.rec)[i] = make_int2(base + off, count);
        a.next[i] = atomicExch(&a.head[p], i);
      } else {
        a.next[i] = kNoRecord;
      }
    }
    __syncthreads();
  }
  live = block_sum(live, s_warp);
  nans = block_sum(nans, s_warp);
  if (t_id == 0) {
    if (live)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.n_vertices),
                (unsigned long long)live);
    if (nans)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.nan_scrubbed),
                (unsigned long long)nans);
  }
  grid_barrier(a.barrier);

  // 2. each pixel's first record adds the pixel's records in tile order
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i = t * kThreads + t_id;
    if (i >= a.n || a.fin[i] == 0 || __ldcg(&a.next[i]) != -1) continue;
    const int p = a.pix[i];
    const int h = __ldcg(&a.head[p]);
    a.head[p] = -1;
    float s[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c] = a.acc[(long long)c * a.pixels + p];
    for (int w0 = 0;; w0 += kWindow) {   // tiles [w0, w0 + kWindow)
      unsigned seen[kWindow / 32] = {};
      unsigned char at[kWindow];
      bool more = false;
      for (int j = h; j >= 0; j = __ldcg(&a.next[j])) {
        const int tt = j / kThreads - w0;
        if (tt >= kWindow) {
          more = true;
        } else if (tt >= 0) {
          seen[tt / 32] |= 1u << (tt % 32);
          at[tt] = (unsigned char)(j % kThreads);
        }
      }
      for (int k = 0; k < kWindow / 32; ++k)
        for (unsigned b = seen[k]; b; b &= b - 1) {
          const int tt = k * 32 + __ffs(b) - 1;
          add_record(a, (w0 + tt) * kThreads + at[tt], s);
        }
      if (!more) break;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) a.acc[(long long)c * a.pixels + p] = s[c];
  }
}

// the most blocks of film_sum_kernel the card holds at once, by device
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, film_sum_kernel,
                                                    kThreads, 0)
          != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

}  // namespace

extern "C" int srt_film_sum(const FilmSumArgs* args, void* stream) {
  FilmSumArgs a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  const int resident = resident_blocks();
  if (resident <= 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorLaunchOutOfResources);
  }
  int grid = (a.n + kThreads - 1) / kThreads;
  if (grid > resident) grid = resident;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)film_sum_kernel, dim3(grid), dim3(kThreads), params, 0,
      (cudaStream_t)stream);
}
