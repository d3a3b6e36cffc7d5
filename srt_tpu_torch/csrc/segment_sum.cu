// The material sum of the train backward: kernel B5's per-lane material
// cotangents (n, kK) summed by each lane's material id into the (m,
// out_cols) table, in an order fixed by the lanes, never by the scheduler.
//
// Replaces no TPU kernel. The JAX package sums B5's outputs outside its
// Pallas kernel with XLA's scatter (srt_tpu/pallas/bounce_bwd.py:308-315,
// .at[mid].add), whose sums come out the same every run. The port's
// index_add_ does it on the card with float atomics: the last bits changed
// from run to run (ROADMAP C18), and at 262,144 lanes into 124 rows the
// atomics queued on a few addresses (0.52 ms a launch, PERF.md).
//
// The order, for each material and column (kernels/segment.py:
// material_sum_order is this order in torch):
//  1. a chunk of 32 lanes: the material's lanes in lane order, from 0;
//  2. a warp: its chunks (consecutive, chunks_for(n) of them) in order,
//     each chunk holding the material added to the warp's sum, from 0;
//  3. a block (kWarps warps, consecutive lanes): its warps' sums in warp
//     order, from the first;
//  4. the grid: lane j of a warp sums the blocks j, j + 32, j + 64, ... in
//     order, from 0, and the 32 lanes' sums meet in a butterfly, each step
//     adding lane j's sum and lane j ^ o's (o = 16, 8, 4, 2, 1): the same
//     two numbers in every pair, so every lane ends with the same bits.
// Columns no input feeds are 0.
//
// One launch. A warp loads all its chunks' rows at once, stages each chunk
// in shared memory and finds each material's lanes (__match_any_sync);
// the (material, column) pairs of a chunk are dealt to the warp's lanes,
// each adding its pair's lanes in order into the warp's table. The block
// writes its partial table; the last kCombiners blocks to arrive (a
// counter, never reset: a launch adds kSpan in all) wait for the others
// and share step 4, a warp an output and eight outputs' loads in flight.
//
// Bound: the bytes, each lane's kK floats and its id read once (44 B) and
// the table written once; one add a value. What the design does about it:
// one coalesced pass over the lanes with every load issued before the
// first add, sums kept in shared memory, and the blocks' partials (blocks
// x m x kK, 635 KB at 262,144 lanes and 124 materials) read by 32 blocks,
// not one.
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

struct SegmentSumArgs {
  const float* g;      // (n, k) per-lane values, rows contiguous
  const int* seg;      // (n,) each lane's row of the table, in [0, m)
  float* part;         // (blocks, m, k) each block's sums
  float* out;          // (m, out_cols) the table
  unsigned* done;      // () blocks arrived, never reset
  int n, k, m, out_cols;
  int col[16];         // the table's column of each of the k inputs
};

}  // extern "C"

namespace {

constexpr int kK = 10;                // inputs a lane (B5's material columns)
constexpr int kStride = kK + 1;       // a staged row, off the banks' period
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunks = 8;
constexpr int kFill = 128;            // blocks that cover an H100's 132 SMs
constexpr int kCombiners = 32;        // blocks that share the last step
constexpr int kBatch = 8;             // outputs a warp loads at once
constexpr int kDeep = 4;              // blocks' loads of an output at once
constexpr int kSparse = 4;            // lanes a material adds one by one
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kSpan = 1u << 20;  // counter arrivals a launch

// chunks of 32 lanes a warp: one, or as many as keep kFill blocks busy
__host__ __device__ int chunks_for(int n) {
  const int c = n / (kFill * kThreads);
  return c < 1 ? 1 : c > kMaxChunks ? kMaxChunks : c;
}

// shared memory: kWarps tables (m, kK), then kWarps staged chunks (32,
// kStride), then kWarps lists of the chunk's materials and their lanes
size_t smem_bytes(int m) {
  return sizeof(float) * (size_t)kWarps * (m * kK + 32 * kStride)
         + sizeof(int) * kWarps * 64;
}

__global__ void __launch_bounds__(kThreads, 2) segment_sum_kernel(
    const SegmentSumArgs a, const int chunks) {
  extern __shared__ float smem[];
  __shared__ int s_rank;
  const int mk = a.m * kK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  float* mine = smem + warp * mk;
  float* stage = smem + kWarps * mk + warp * 32 * kStride;
  int* groups = reinterpret_cast<int*>(smem + kWarps * (mk + 32 * kStride))
                + warp * 64;                 // [0, 32) lanes, [32, 64) ids
  for (int e = threadIdx.x; e < kWarps * mk; e += kThreads) smem[e] = 0.0f;

  // every chunk's rows of the warp, loaded before any is added
  const int base = (blockIdx.x * kWarps + warp) * chunks * 32;
  float v[kMaxChunks][kK];
  int id[kMaxChunks];
#pragma unroll
  for (int q = 0; q < kMaxChunks; ++q) {
    const int i = base + q * 32 + l;
    const bool in = q < chunks && i < a.n;
    id[q] = in ? a.seg[i] : -1;
    const float2* row = reinterpret_cast<const float2*>(a.g + (long long)i * kK);
#pragma unroll
    for (int c = 0; c < kK / 2; ++c) {
      const float2 x = in ? row[c] : make_float2(0.0f, 0.0f);
      v[q][2 * c] = x.x;
      v[q][2 * c + 1] = x.y;
    }
  }
  __syncthreads();

#pragma unroll
  for (int q = 0; q < kMaxChunks; ++q) {
    if (q >= chunks) break;
#pragma unroll
    for (int c = 0; c < kK; ++c) stage[l * kStride + c] = v[q][c];
    const unsigned same = __match_any_sync(kAll, id[q]);
    const bool lead = id[q] >= 0 && __ffs(same) - 1 == l;
    const unsigned leads = __ballot_sync(kAll, lead);
    if (lead) {
      const int gi = __popc(leads & ((1u << l) - 1u));
      groups[gi] = (int)same;
      groups[32 + gi] = id[q];
    }
    __syncwarp();
    // the chunk's (material, column) pairs, dealt to the lanes; a
    // material of many lanes adds every lane's value or +0, which leaves a
    // sum from +0 as it is, with the loads issued before the adds
    for (int p = l; p < __popc(leads) * kK; p += 32) {
      const int gi = p / kK, c = p % kK;
      const unsigned b0 = (unsigned)groups[gi];
      float s = 0.0f;
      if (__popc(b0) > kSparse) {
        float x[32];
#pragma unroll
        for (int j = 0; j < 32; ++j)
          x[j] = (b0 >> j) & 1u ? stage[j * kStride + c] : 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) s += x[j];
      } else {
        for (unsigned b = b0; b; b &= b - 1)
          s += stage[(__ffs(b) - 1) * kStride + c];
      }
      mine[groups[32 + gi] * kK + c] += s;
    }
    __syncwarp();
  }
  __syncthreads();

  // the block's sums, its warps in order
  float* part = a.part + (long long)blockIdx.x * mk;
  for (int e = threadIdx.x; e < mk; e += kThreads) {
    float t = smem[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += smem[w * mk + e];
    part[e] = t;
  }
  __syncthreads();
  const unsigned blocks = gridDim.x;
  const int combiners = blocks < kCombiners ? (int)blocks : kCombiners;
  unsigned target = 0;
  cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(*a.done);
  if (threadIdx.x == 0) {   // release: the block's partials before it
    const unsigned add = blockIdx.x == 0 ? kSpan - blocks + 1u : 1u;
    const unsigned old = count.fetch_add(add, cuda::memory_order_release);
    const unsigned from = old & ~(kSpan - 1u);
    unsigned rank = old - from;
    if (rank >= kSpan - blocks + 1u) rank -= kSpan - blocks;
    s_rank = (int)rank - ((int)blocks - combiners);
    target = from + kSpan;
  }
  __syncthreads();
  const int f = s_rank;
  if (f < 0) return;

  // the last arrivals: wait for every block, then step 4, a warp an output
  if (threadIdx.x == 0) {
    while ((int)(count.load(cuda::memory_order_acquire) - target) < 0) {
    }
  }
  __syncthreads();
  int colof[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) colof[c] = a.col[c];
  const int gw = f * kWarps + warp, warps = combiners * kWarps;
  for (int e0 = gw * kBatch; e0 < mk; e0 += warps * kBatch) {
    float t[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) t[u] = 0.0f;
    for (int b0 = l; b0 < (int)blocks; b0 += 32 * kDeep) {
      float x[kDeep][kBatch];
#pragma unroll
      for (int i = 0; i < kDeep; ++i)
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int b = b0 + 32 * i;
          x[i][u] = b < (int)blocks && e0 + u < mk
                        ? __ldcg(a.part + (long long)b * mk + e0 + u)
                        : 0.0f;
        }
#pragma unroll
      for (int i = 0; i < kDeep; ++i)
#pragma unroll
        for (int u = 0; u < kBatch; ++u) t[u] += x[i][u];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kBatch; ++u) t[u] += __shfl_xor_sync(kAll, t[u], o);
    if (l < kBatch && e0 + l < mk) {
      float x = t[0];
#pragma unroll
      for (int u = 1; u < kBatch; ++u)
        if (l == u) x = t[u];
      const int r = (e0 + l) / kK, c = (e0 + l) % kK;
      int oc = 0;
#pragma unroll
      for (int q = 0; q < kK; ++q)
        if (q == c) oc = colof[q];
      a.out[(long long)r * a.out_cols + oc] = x;
    }
  }
  // the columns no input feeds
  for (int e = f * kThreads + threadIdx.x; e < a.m * a.out_cols;
       e += combiners * kThreads) {
    bool fed = false;
#pragma unroll
    for (int q = 0; q < kK; ++q) fed |= colof[q] == e % a.out_cols;
    if (!fed) a.out[e] = 0.0f;
  }
}

// the grid's blocks at n lanes (kernels/segment.py:blocks_for)
int blocks_for(int n) {
  const int window = kThreads * chunks_for(n);
  return (n + window - 1) / window;
}

}  // namespace

extern "C" int srt_segment_sum(const SegmentSumArgs* args, void* stream) {
  const SegmentSumArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  if (a.k != kK) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.m);
  // the attribute once a device, raised only for a larger table
  static size_t set_for[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || set_for[dev] < smem) {
    err = cudaFuncSetAttribute(segment_sum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) set_for[dev] = smem;
  }
  segment_sum_kernel<<<blocks_for(a.n), kThreads, smem,
                       (cudaStream_t)stream>>>(a, chunks_for(a.n));
  return (int)cudaGetLastError();
}
