// One bounce of an explicit wavefront state: the forward of the train
// step, and the bounce of the regeneration engine on triangle scenes.
//
// Replaces srt_tpu/pallas/bounce.py:_kernel in its per-bounce mode
// (regen=False, launched by fused_bounce), its parity plane included. For
// every lane: closest hit, emission (the env dome's image texture looked
// up here), the diffuse branch and roulette -- bounce_core.cuh's
// bounce(), the same code as the regeneration kernel's. No regeneration,
// no ranks, no depth cap: the caller applies the cap
// (srt_tpu/render/regen_scan.py:126). Out of place, because autograd
// keeps the inputs for the backward kernel.
//
// External-hit mode (n_tris > 0, the template's kExt; bounce.py's
// has_ext): the triangle BVH kernel (intersect_tris.cu) has left each
// lane's closest triangle as (t, u, v, idx). This kernel assembles the
// hit from the triangle tables -- barycentrics (1-u-v, u, v), the
// normalised interpolated normal, the interpolated uv, tri_mat[idx], the
// math of srt_tpu/render/intersect.py:396-403 -- where the JAX package
// gathers in XLA between the two launches, and lets it compete after the
// spheres and rects. With or without triangles the kernel is the rich
// instantiation (kRich) when the scene has any of these families (rich !=
// 0), and lean otherwise: the media sweep (sphere and box media, after the
// triangle hit, as srt_tpu/pallas/bounce.py:1268-1275), the specular
// branch of metal, dielectric and isotropic lanes, checker, marble and
// image textures, sphere lights.
//
// State is (n, 3) rows for o, d, beta, radiance; time float; salt (int32
// bit patterns), depth int32, alive bool. A dead lane passes through with
// depth + 1. With moving spheres (moving != 0, the template's kMoving) a
// lane sees each sphere at its centre at the lane's time; the static
// instantiations do not read the time.
//
// The reference-parity estimator (parity != 0, the template's kParity,
// with every other family): each lane's heap slot starts the bounce at 0
// or 1e30 (parity_slot; 0 under parity_no_stale), the diffuse branch
// draws as bounce_core.cuh's diffuse_parity, and the slot after the
// bounce goes to stale_out, (n,) float32. The incoming stale plane is not
// read, as in the JAX kernel (bounce.py:966-970: the slot does not live
// across bounces). JAX's TPU kernel evaluates every round on every lane
// under masks; here a lane whose pdf turned positive leaves the loop, and
// a round evaluates the stored pdf only where it took the Beckmann BSDF.
//
// Layout: a block holds kLanes = 64 lanes and G threads a lane, the lane's
// shares (template G: 1, 2, 4 or 8, picked on the host from the lane count
// and the spheres, kernels/bounce.py:sweep_shares), share p being threads
// p*kLanes .. p*kLanes + kLanes - 1, whole warps. Each share reads the
// lane's ray and sweeps every G-th sphere (bounce_core.cuh:sphere_share);
// share 0 combines them (nearest_share) and runs the rest of the bounce on
// one warp per 32 lanes, so the shading keeps full warps; the winner is
// closest_hit's, so the bits are the one-thread kernel's. 64 lanes a block
// put the train state's 16,384 lanes on 256 blocks, so every SM has work.
// The kernel and its launch live in bounce_kernel.cuh; bounce.cu (G = 1,
// and the entry point), bounce_g2.cu, bounce_g4.cu and bounce_g8.cu each
// compile one G's sixteen instantiations, so nvcc builds them in parallel.
//
// Bound: instructions and latency, as the regeneration kernel: the sphere
// sweep (split over the shares, one 16-byte shared load a test) and then
// the shading chain (registers and divergence), not bytes: a lane reads
// 57 B (73 B with a triangle hit) and writes 53 B (57 B under parity).
#include "bounce_kernel.cuh"

namespace srt {
template int launch_shares<1>(const BounceArgs&, cudaStream_t);
}  // namespace srt

extern "C" int srt_bounce(const BounceArgs* args, void* stream) {
  const BounceArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.shares) {
    case 1: return srt::launch_shares<1>(a, s);
    case 2: return srt::launch_shares<2>(a, s);
    case 4: return srt::launch_shares<4>(a, s);
    case 8: return srt::launch_shares<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
