// Kernel B2 (bounce.cu) with 2 threads a lane: its sixteen
// instantiations, compiled apart from the other G so nvcc builds them
// in parallel.
#include "bounce_kernel.cuh"

namespace srt {
template int launch_shares<2>(const BounceArgs&, cudaStream_t);
}  // namespace srt
