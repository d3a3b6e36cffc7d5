// Kernel B2 (bounce.cu) with 4 threads a lane: its sixteen
// instantiations, compiled apart from the other G so nvcc builds them
// in parallel.
#include "bounce_kernel.cuh"

namespace srt {
template int launch_shares<4>(const BounceArgs&, cudaStream_t);
}  // namespace srt
