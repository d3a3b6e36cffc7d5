// Kernel B5's Jacobian column map (bounce_bwd.cu): the columns of each
// instantiation, the width K of a pass compiled for each, the passes, and
// where each column's contracted value goes. Plain C++ apart from the
// qualifiers, so a host compiler builds it too: tests/test_torch_kernel.py
// checks the map with g++.
#pragma once

#ifdef __CUDACC__
#define SRT_HD __host__ __device__ __forceinline__
#else
#define SRT_HD inline
#endif

namespace srt {
namespace bwd {

// Jacobian columns: o(3) d(3) beta(3) p0 p1 colour(3), and the rich
// second colour(3)
template <bool kRich>
constexpr int kCols = kRich ? 17 : 14;
// The width K (Jacobian columns a thread) each instantiation is compiled
// for: of lean K = 7, 4, 2, 1 and rich K = 6, 3, 2, 1, the fastest on
// every state of chip_smoke.py phases 5 and 19 on one H100 (PERF.md, B5)
template <bool kRich>
constexpr int kWidth = kRich ? 3 : 7;
template <int K, bool kRich>
constexpr int kPasses = (kCols<kRich> + K - 1) / K;

// The per-lane outputs: the cotangents of o, d, beta (n, 3) and the
// material row (n, 10) of fields 1-4 and 6-11
struct Grads {
  float* o;
  float* d;
  float* beta;
  float* mat;
};

// Where Jacobian column col of lane i goes: o, d, beta (0-8), then the
// material row: parameters 0-1 (9-10) to entries 0-1, the colour (11-13)
// to 4-6, the second colour (14-16) to 7-9
SRT_HD float* column_slot(const Grads& g, int i, int col) {
  if (col < 3) return g.o + 3 * i + col;
  if (col < 6) return g.d + 3 * i + col - 3;
  if (col < 9) return g.beta + 3 * i + col - 6;
  if (col < 11) return g.mat + 10 * i + col - 9;
  return g.mat + 10 * i + col - 7;
}

// Pass p of lane i: its columns p*K .. p*K + K - 1 (those below kCols),
// c[k] the contracted column p*K + k
template <int K, bool kRich>
SRT_HD void store_pass(const Grads& g, int i, int p, const float* c) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (p * K + k < kCols<kRich>) *column_slot(g, i, p * K + k) = c[k];
}

// The material entries of lane i that no column feeds, 0: parameters 2-3,
// read by no branch, and on the lean instantiation the second colour
template <bool kRich>
SRT_HD void store_unfed(float* mat, int i) {
  float* gm = mat + 10 * i;
  gm[2] = 0.0f;
  gm[3] = 0.0f;
  if (!kRich) {
    gm[7] = 0.0f;
    gm[8] = 0.0f;
    gm[9] = 0.0f;
  }
}

}  // namespace bwd
}  // namespace srt
