// The material sum of the train backward: kernel B5's per-lane material
// cotangents (n, k) summed by each lane's material id into the (m,
// out_cols) table, in an order fixed by the lanes, never by the scheduler.
//
// Replaces no TPU kernel. The JAX package sums B5's outputs outside its
// Pallas kernel with XLA's scatter (srt_tpu/pallas/bounce_bwd.py:308-315,
// .at[mid].add), whose sums come out the same every run. The port's
// index_add_ does it on the card with float atomics: the last bits changed
// from run to run (ROADMAP C18), and at 262,144 lanes into 124 rows the
// atomics queued on a few addresses (551 us a launch, PERF.md).
//
// One launch. Each block takes a window of consecutive lanes; each of its
// warps `chunks` chunks of 32 lanes, in order (chunks_for: 1 to 8 by the
// lanes alone, so that the grid covers the card's SMs; the order of the
// sums is then fixed by the lanes' count too). In a chunk the lanes
// of one material find each other (__match_any_sync) and their lowest lane
// adds their values in lane order, read by shuffles, into the warp's own
// (m, k) sums in shared memory: no two lanes of a warp add to one row at
// once. The block then adds its warps' sums in warp order into its row of
// partial sums, and the last block to finish (a counter, back to 0 for the
// next launch) adds every block's partials in block order into the table,
// zeros in the columns no input feeds. So a material's sum is always the
// same sum of the same numbers: lanes in order within a chunk, chunks in
// order within a warp, warps within a block, blocks within the grid. A run
// of one material over most of the lanes (the floor) is summed by every
// block at once, not lane by lane.
//
// Bound: the bytes, each lane's k floats and its id read once (44 B at
// k = 10) and the table written once; one add a value. What the design
// does about it: one pass over the lanes, coalesced, sums kept in shared
// memory, and a second pass over blocks x m x k partials (640 KB at
// 262,144 lanes and 124 materials) by one block. (That pass with its
// loads unrolled 8 or 16 deep, the same sums, was slower on the H100.)
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

struct SegmentSumArgs {
  const float* g;      // (n, k) per-lane values, rows contiguous
  const int* seg;      // (n,) each lane's row of the table, in [0, m)
  float* part;         // (blocks, m, k) each block's sums
  float* out;          // (m, out_cols) the table
  unsigned* done;      // () blocks finished, 0 between launches
  int n, k, m, out_cols;
  int col[16];         // the table's column of each of the k inputs
};

}  // extern "C"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunks = 8;
constexpr int kFill = 128;     // blocks that cover an H100's 132 SMs once

// chunks of 32 lanes a warp: one, or as many as keep kFill blocks busy
int chunks_for(int n) {
  const int c = n / (kFill * kThreads);
  return c < 1 ? 1 : c > kMaxChunks ? kMaxChunks : c;
}

__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const SegmentSumArgs a, const int chunks) {
  extern __shared__ float s_sum[];   // (kWarps, m, k)
  __shared__ bool s_last;
  const int mk = a.m * a.k;
  for (int e = threadIdx.x; e < kWarps * mk; e += kThreads) s_sum[e] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  float* mine = s_sum + warp * mk;
  const int base = (blockIdx.x * kWarps + warp) * chunks * 32;
  for (int ch = 0; ch < chunks; ++ch) {
    const int i = base + ch * 32 + l;
    const bool in = i < a.n;
    const int s = in ? a.seg[i] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, s);
    const bool leader = (int)(__ffs(same) - 1) == l && in;
    for (int c = 0; c < a.k; ++c) {
      const float v = in ? a.g[(long long)i * a.k + c] : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float x = __shfl_sync(0xffffffffu, v, j);
        if ((same >> j) & 1u) sum += x;
      }
      if (leader) mine[s * a.k + c] += sum;
    }
  }
  __syncthreads();

  // the block's sums, its warps in order
  float* part = a.part + (long long)blockIdx.x * mk;
  for (int e = threadIdx.x; e < mk; e += kThreads) {
    float t = s_sum[e];
    for (int w = 1; w < kWarps; ++w) t += s_sum[w * mk + e];
    part[e] = t;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block: every block's sums in block order
  __threadfence();
  for (int e = threadIdx.x; e < a.m * a.out_cols; e += kThreads) {
    const int r = e / a.out_cols, oc = e % a.out_cols;
    int c = -1;
    for (int q = 0; q < a.k; ++q)
      if (a.col[q] == oc) c = q;
    float t = 0.0f;
    if (c >= 0) {
      const float* p = a.part + r * a.k + c;
      t = __ldcg(p);
      for (int b = 1; b < (int)gridDim.x; ++b)
        t += __ldcg(p + (long long)b * mk);
    }
    a.out[e] = t;
  }
  if (threadIdx.x == 0) atomicExch(a.done, 0u);
}

}  // namespace

extern "C" int srt_segment_sum_blocks(int n) {
  const int window = kThreads * chunks_for(n);
  return (n + window - 1) / window;
}

extern "C" int srt_segment_sum(const SegmentSumArgs* args, void* stream) {
  const SegmentSumArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * kWarps * a.m * a.k;
  cudaError_t err = cudaFuncSetAttribute(
      segment_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  segment_sum_kernel<<<srt_segment_sum_blocks(a.n), kThreads, smem,
                       (cudaStream_t)stream>>>(a, chunks_for(a.n));
  return (int)cudaGetLastError();
}
