// Native binned-SAH BVH builder with skip-link flattening (a copy of
// srt_tpu/native/bvh_builder.cpp, the JAX package's builder).
//
// Host side of scene build: the numpy builder in
// srt_tpu_torch/accel/bvh.py takes minutes on a mesh of a million
// triangles (teapot_scene at divs=100, reference teapot.h:77); this one
// takes about a second. The layout it emits is identical to the numpy
// builder's, bit for bit: a depth-first node array with skip links (on
// AABB hit descend to i+1, on miss jump to skip[i]) over a contiguous
// reordered triangle range per leaf. The reference instead builds a
// pointer tree with random-axis median splits (Raytracing_n/bvh.h:21-55).
//
// Exposed via a plain C ABI, loaded with ctypes
// (srt_tpu_torch/native/__init__.py compiles it at first use).
//
// Algorithm notes (kept in lockstep with the Python reference
// implementation so both emit the same tree):
//   * split axis   = argmax of centroid extent
//   * 16 bins over centroid positions along that axis
//   * SAH cost     = Nl*halfArea(left bounds) + Nr*halfArea(right bounds)
//   * degenerate extent or no valid split -> median split (stable order)
//   * leaves hold <= leaf_size triangles
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

constexpr int kBins = 16;

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline double halfArea(const Vec3& lo, const Vec3& hi) {
  double dx = std::max(0.0f, hi.x - lo.x);
  double dy = std::max(0.0f, hi.y - lo.y);
  double dz = std::max(0.0f, hi.z - lo.z);
  return dx * dy + dy * dz + dz * dx;
}

struct Builder {
  const Vec3* tri_lo;   // (T) per-triangle AABB
  const Vec3* tri_hi;
  const Vec3* centroid; // (T)
  int leaf_size;

  // Output arrays (DFS order).
  std::vector<Vec3> lo, hi;
  std::vector<int32_t> skip, first, count;
  std::vector<int64_t> order;

  // Scratch: triangle id list, partitioned in place per subtree.
  std::vector<int64_t> ids;

  // Explicit stack instead of recursion (640k tris => depth can exceed
  // Python's default recursion limit; here it is just a vector).
  struct Frame {
    int64_t begin, end;  // range in ids
    int32_t node;        // node index, -1 => not yet emitted
  };

  void build(int64_t t) {
    ids.resize(t);
    for (int64_t i = 0; i < t; ++i) ids[i] = i;
    lo.reserve(2 * t);
    hi.reserve(2 * t);
    skip.reserve(2 * t);
    first.reserve(2 * t);
    count.reserve(2 * t);
    order.reserve(t);

    // DFS with a post-order fixup for skip links: a node's skip is the
    // node index right after its whole subtree, known when the subtree
    // closes. We emulate the recursion with (enter, exit) events.
    struct Ev {
      int64_t begin, end;
      int32_t node;   // valid for exit events
      bool exit;
    };
    std::vector<Ev> stack;
    stack.push_back({0, t, -1, false});
    while (!stack.empty()) {
      Ev ev = stack.back();
      stack.pop_back();
      if (ev.exit) {
        skip[ev.node] = static_cast<int32_t>(lo.size());
        continue;
      }
      int32_t node = emitNode(ev.begin, ev.end);
      int64_t n = ev.end - ev.begin;
      if (n <= leaf_size) {
        first[node] = static_cast<int32_t>(order.size());
        count[node] = static_cast<int32_t>(n);
        for (int64_t i = ev.begin; i < ev.end; ++i) order.push_back(ids[i]);
        skip[node] = node + 1;
        continue;
      }
      int64_t mid = split(ev.begin, ev.end);
      // exit event first so it resolves after both children.
      stack.push_back({ev.begin, ev.end, node, true});
      stack.push_back({mid, ev.end, -1, false});
      stack.push_back({ev.begin, mid, -1, false});
    }
  }

  int32_t emitNode(int64_t begin, int64_t end) {
    Vec3 l = tri_lo[ids[begin]], h = tri_hi[ids[begin]];
    for (int64_t i = begin + 1; i < end; ++i) {
      l = vmin(l, tri_lo[ids[i]]);
      h = vmax(h, tri_hi[ids[i]]);
    }
    lo.push_back(l);
    hi.push_back(h);
    skip.push_back(-1);
    first.push_back(-1);
    count.push_back(0);
    return static_cast<int32_t>(lo.size()) - 1;
  }

  // Partition ids[begin:end); returns the split point.
  int64_t split(int64_t begin, int64_t end) {
    Vec3 cmin = centroid[ids[begin]], cmax = cmin;
    for (int64_t i = begin + 1; i < end; ++i) {
      cmin = vmin(cmin, centroid[ids[i]]);
      cmax = vmax(cmax, centroid[ids[i]]);
    }
    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 1e-12f) return medianSplit(begin, end, axis);

    float c0 = (&cmin.x)[axis];
    float inv = 1.0f / ext[axis];

    Vec3 bin_lo[kBins], bin_hi[kBins];
    int64_t bin_n[kBins] = {0};
    constexpr float inf = std::numeric_limits<float>::infinity();
    for (int b = 0; b < kBins; ++b) {
      bin_lo[b] = {inf, inf, inf};
      bin_hi[b] = {-inf, -inf, -inf};
    }
    for (int64_t i = begin; i < end; ++i) {
      int64_t id = ids[i];
      float rel = ((&centroid[id].x)[axis] - c0) * inv;
      int b = std::min(static_cast<int>(rel * kBins), kBins - 1);
      if (b < 0) b = 0;
      bin_lo[b] = vmin(bin_lo[b], tri_lo[id]);
      bin_hi[b] = vmax(bin_hi[b], tri_hi[id]);
      bin_n[b]++;
    }

    Vec3 pre_lo[kBins], pre_hi[kBins], suf_lo[kBins], suf_hi[kBins];
    int64_t pre_n[kBins], suf_n[kBins];
    pre_lo[0] = bin_lo[0];
    pre_hi[0] = bin_hi[0];
    pre_n[0] = bin_n[0];
    for (int b = 1; b < kBins; ++b) {
      pre_lo[b] = vmin(pre_lo[b - 1], bin_lo[b]);
      pre_hi[b] = vmax(pre_hi[b - 1], bin_hi[b]);
      pre_n[b] = pre_n[b - 1] + bin_n[b];
    }
    suf_lo[kBins - 1] = bin_lo[kBins - 1];
    suf_hi[kBins - 1] = bin_hi[kBins - 1];
    suf_n[kBins - 1] = bin_n[kBins - 1];
    for (int b = kBins - 2; b >= 0; --b) {
      suf_lo[b] = vmin(suf_lo[b + 1], bin_lo[b]);
      suf_hi[b] = vmax(suf_hi[b + 1], bin_hi[b]);
      suf_n[b] = suf_n[b + 1] + bin_n[b];
    }

    double best_cost = std::numeric_limits<double>::infinity();
    int best_bin = -1;
    for (int b = 0; b < kBins - 1; ++b) {
      int64_t nl = pre_n[b], nr = suf_n[b + 1];
      if (nl == 0 || nr == 0) continue;
      double cost = nl * halfArea(pre_lo[b], pre_hi[b]) +
                    nr * halfArea(suf_lo[b + 1], suf_hi[b + 1]);
      if (cost < best_cost) {
        best_cost = cost;
        best_bin = b;
      }
    }
    if (best_bin < 0) return medianSplit(begin, end, axis);

    // Stable partition: ids with bin <= best_bin first, preserving order
    // (matches numpy boolean-mask indexing in the Python builder).
    std::vector<int64_t> lhs, rhs;
    lhs.reserve(end - begin);
    rhs.reserve(end - begin);
    for (int64_t i = begin; i < end; ++i) {
      int64_t id = ids[i];
      float rel = ((&centroid[id].x)[axis] - c0) * inv;
      int b = std::min(static_cast<int>(rel * kBins), kBins - 1);
      if (b < 0) b = 0;
      (b <= best_bin ? lhs : rhs).push_back(id);
    }
    std::copy(lhs.begin(), lhs.end(), ids.begin() + begin);
    std::copy(rhs.begin(), rhs.end(), ids.begin() + begin + lhs.size());
    return begin + static_cast<int64_t>(lhs.size());
  }

  int64_t medianSplit(int64_t begin, int64_t end, int axis) {
    int64_t half = (end - begin) / 2;
    std::stable_sort(ids.begin() + begin, ids.begin() + end,
                     [&](int64_t a, int64_t b) {
                       return (&centroid[a].x)[axis] < (&centroid[b].x)[axis];
                     });
    return begin + half;
  }
};

}  // namespace

extern "C" {

// tri_verts: (T, 3, 3) float32 row-major. Outputs must be preallocated by
// the caller to capacity 2*T-1 nodes (lo/hi: (2T-1)*3 floats; skip/first/
// count: 2T-1 int32) and order: T int64. Returns the node count actually
// used, or -1 on error.
int64_t srt_build_bvh(const float* tri_verts, int64_t n_tris, int leaf_size,
                      float* out_lo, float* out_hi, int32_t* out_skip,
                      int32_t* out_first, int32_t* out_count,
                      int64_t* out_order) {
  if (n_tris <= 0 || leaf_size <= 0) return -1;
  std::vector<Vec3> tlo(n_tris), thi(n_tris), cen(n_tris);
  for (int64_t i = 0; i < n_tris; ++i) {
    const float* v = tri_verts + i * 9;
    Vec3 a{v[0], v[1], v[2]}, b{v[3], v[4], v[5]}, c{v[6], v[7], v[8]};
    tlo[i] = vmin(a, vmin(b, c));
    thi[i] = vmax(a, vmax(b, c));
    cen[i] = {0.5f * (tlo[i].x + thi[i].x), 0.5f * (tlo[i].y + thi[i].y),
              0.5f * (tlo[i].z + thi[i].z)};
  }
  Builder bl;
  bl.tri_lo = tlo.data();
  bl.tri_hi = thi.data();
  bl.centroid = cen.data();
  bl.leaf_size = leaf_size;
  bl.build(n_tris);

  int64_t n_nodes = static_cast<int64_t>(bl.lo.size());
  if (n_nodes > 2 * n_tris) return -1;  // caller capacity exceeded
  std::memcpy(out_lo, bl.lo.data(), n_nodes * sizeof(Vec3));
  std::memcpy(out_hi, bl.hi.data(), n_nodes * sizeof(Vec3));
  std::memcpy(out_skip, bl.skip.data(), n_nodes * sizeof(int32_t));
  std::memcpy(out_first, bl.first.data(), n_nodes * sizeof(int32_t));
  std::memcpy(out_count, bl.count.data(), n_nodes * sizeof(int32_t));
  std::memcpy(out_order, bl.order.data(), n_tris * sizeof(int64_t));
  return n_nodes;
}

}  // extern "C"
