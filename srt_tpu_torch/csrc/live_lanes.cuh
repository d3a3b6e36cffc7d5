// The dead lanes and the list of live lanes of kernel B5's cooperative
// launch over the list (bounce_bwd.cu): the live lanes listed on the card,
// in lane order, for the sweep, and every dead lane's outputs written.
//
// list_live: each block takes a contiguous share of the lanes (a multiple
// of 32 long) and each of its warps a contiguous stretch of that share;
//  1. each warp counts its stretch's live lanes (ballots), the block's
//     count goes to its slot of ``counts``;
//  2. after a grid barrier, each block sums the counts of the blocks
//     before it and of all of them (a few hundred values) and each warp
//     writes its live lanes' ids from there, in lane order.
// The caller meets the grid again before it reads the list. Nothing is read
// back to the host: the count stays on the card.
// pass_dead, once a block has no tile of the list left to sweep: the dead
// lanes' rows passed through, their material rows and ids 0 (what the
// sweep writes for a lane it does not shade), in runs the blocks draw, so
// on a bounce with few live lanes it runs beside their tiles.
#pragma once
#include <cuda_runtime.h>

#include "grid_barrier.cuh"

namespace srt {
namespace live {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxWarps = 32;          // of a block
// the blocks a launch may have: the length of its per-block counts
constexpr int kMaxBlocks = 4096;
constexpr int kChunks = 2;             // 32-lane chunks a warp has in flight
constexpr int kRunLanes = 256;         // lanes a warp passes through a draw

struct Lanes {
  const unsigned char* alive;  // (n,) bool
  int n;
  int* list;                   // (n,) the live lanes, lane order, first
  int* counts;                 // (gridDim.x,) each block's live lanes
  unsigned* barrier;           // (1,) arrivals, never reset
  long long* live;             // null, or where to add the live lanes
};

// What a dead lane writes: its four (n, 3) rows' cotangents passed through
// (dst = src), its (n, 10) material row 0 and its (n,) material id 0
struct PassThrough {
  const float* src[4];
  float* dst[4];
  float* mat;
  int* id;
};

struct Shared {
  int warp[kMaxWarps];         // each warp's live lanes
  int before[kMaxWarps], total[kMaxWarps];
};

struct Draw {
  int run;                     // the block's run of lanes
};

// [lo, hi) of n lanes cut into `parts` stretches, each a multiple of 32
// long but the last: stretch k of the ones starting at `from`
__device__ __forceinline__ void stretch(int from, int n, int parts, int k,
                                        int& lo, int& hi) {
  const int per = ((n - from + parts - 1) / parts + 31) / 32 * 32;
  lo = min(n, from + k * per);
  hi = min(n, lo + per);
}

// The dead lanes of a warp's stretch [lo, hi) (lo a multiple of 32),
// kChunks chunks of 32 lanes at a time: each thread reads one lane's flag,
// then three of the 96 floats of each of the chunk's four rows, ten of its
// 320 material floats and one id, and writes those of dead lanes (bits of
// the ballots, no second read of the flags)
__device__ inline void pass_stretch(const unsigned char* alive, int lo,
                                    int hi, const PassThrough& p) {
  const int l = threadIdx.x % 32;
  for (int base = lo; base < hi; base += 32 * kChunks) {
    unsigned dead[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = base + 32 * c + l;
      const unsigned in = __ballot_sync(kAll, i < hi);
      dead[c] = in & ~__ballot_sync(kAll, i < hi && alive[i]);
    }
    float v[kChunks][4][3];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int f = 32 * k + l;
        const bool d = (dead[c] >> (f / 3)) & 1u;
        const long long e = 3LL * (base + 32 * c) + f;
#pragma unroll
        for (int r = 0; r < 4; ++r) v[c][r][k] = d ? p.src[r][e] : 0.0f;
      }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (!dead[c]) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int f = 32 * k + l;
        if ((dead[c] >> (f / 3)) & 1u) {
          const long long e = 3LL * (base + 32 * c) + f;
#pragma unroll
          for (int r = 0; r < 4; ++r) p.dst[r][e] = v[c][r][k];
        }
      }
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        const int f = 32 * k + l;
        if ((dead[c] >> (f / 10)) & 1u)
          p.mat[10LL * (base + 32 * c) + f] = 0.0f;
      }
      if ((dead[c] >> l) & 1u) p.id[base + 32 * c + l] = 0;
    }
  }
}

// Every dead lane's outputs, by every thread of every block: the blocks
// draw runs of kRunLanes lanes a warp from ``*next`` (0 at the first draw)
// until none is left, so a block that is still sweeping a tile leaves its
// runs to the others
__device__ inline void pass_dead(const Lanes& a, const PassThrough& p,
                                 int* next) {
  __shared__ Draw draw;
  const int run = blockDim.x / 32 * kRunLanes, w = threadIdx.x / 32;
  for (;;) {
    if (threadIdx.x == 0) draw.run = atomicAdd(next, 1);
    __syncthreads();
    const long long lo = (long long)draw.run * run + w * kRunLanes;
    __syncthreads();   // read before the next draw
    if (lo - w * kRunLanes >= a.n) break;
    if (lo < a.n)
      pass_stretch(a.alive, (int)lo, (int)min(lo + kRunLanes, (long long)a.n),
                   p);
  }
}

// The sum over the block of each thread's x, in every thread
__device__ __forceinline__ int block_sum(int x, int* slots) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  if (threadIdx.x % 32 == 0) slots[threadIdx.x / 32] = x;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) s += slots[w];
  return s;
}

// Phases 1 and 2 above but the dead lanes' outputs (pass_dead), by every
// thread of every block; returns the live lanes, the list's length, in
// every thread. blockDim.x is a multiple of 32, at most 32 * kMaxWarps;
// gridDim.x at most kMaxBlocks.
__device__ inline int list_live(const Lanes& a) {
  __shared__ Shared sh;
  const int warps = blockDim.x / 32, w = threadIdx.x / 32,
            l = threadIdx.x % 32;
  int lo, hi, wlo, whi;
  stretch(0, a.n, gridDim.x, blockIdx.x, lo, hi);
  stretch(lo, hi, warps, w, wlo, whi);
  int count = 0;
  for (int base = wlo; base < whi; base += 32) {
    const int i = base + l;
    count += __popc(__ballot_sync(kAll, i < whi && a.alive[i]));
  }
  if (l == 0) sh.warp[w] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int k = 0; k < warps; ++k) s += sh.warp[k];
    a.counts[blockIdx.x] = s;
  }
  grid_barrier(a.barrier);

  int before = 0, total = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    const int c = __ldcg(a.counts + b);
    total += c;
    if (b < (int)blockIdx.x) before += c;
  }
  before = block_sum(before, sh.before);
  total = block_sum(total, sh.total);
  int at = before;
  for (int k = 0; k < w; ++k) at += sh.warp[k];
  for (int base = wlo; base < whi; base += 32) {
    const int i = base + l;
    const bool on = i < whi && a.alive[i];
    const unsigned m = __ballot_sync(kAll, on);
    if (on) a.list[at + __popc(m & ((1u << l) - 1u))] = i;
    at += __popc(m);
  }
  if (a.live != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.live),
              (unsigned long long)total);
  return total;
}

}  // namespace live
}  // namespace srt
