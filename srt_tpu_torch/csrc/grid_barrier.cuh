// The grid barrier of a cooperative launch, shared by the film sum
// (film_sum.cu) and B5's list of live lanes (live_lanes.cuh).
#pragma once
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace srt {

// Barrier arrivals a span: a meeting of the grid adds kSpan in all
constexpr unsigned kSpan = 1u << 20;

// Every block of the grid meets here; the launch is cooperative, so all of
// them are resident. A block's arrival is an add with release order after
// its threads meet (its writes before it), its wait loads with acquire
// order. The counter is zero at first and never reset: block 0 adds kSpan
// less the other blocks' arrivals, so a meeting adds kSpan in all and
// every arrival of one meeting lies in one span.
__device__ inline void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(*bar);
    const unsigned add = blockIdx.x == 0 ? kSpan - gridDim.x + 1u : 1u;
    const unsigned target =
        (count.fetch_add(add, cuda::memory_order_release) & ~(kSpan - 1u))
        + kSpan;
    while ((int)(count.load(cuda::memory_order_acquire) - target) < 0) {
    }
  }
  __syncthreads();
}

}  // namespace srt
