"""Kernel B3's records and split walk, on the CPU: the 16-byte-aligned
tables of ``kernels/intersect.py:pack_tables`` (B4's layout, for the
single-level BVH) and the walk of ``csrc/intersect_tris.cu`` with each
ray on G threads.

The tables must hold what the scene's BVH holds (``bvh_*`` and ``tri_*``)
bit for bit, the edges the float32 differences of the corners.
:func:`walk_split` steps through the kernel's walk in numpy, every ray one
node a round as the kernel's threads do, with a leaf's triangles dealt to
G shares that each test theirs against the ray's best and are folded in
the kernel's butterfly (the nearest, the lowest index on a tie) before the
next box test. At G = 1, 2 and 4 it must find the plain walk's ``(t, u,
v, idx)`` to the bit and visit its nodes and test its triangles, on
cornell_boxes, a clustered soup and a small teapot; and the host's G rule
must keep within the widest leaf and the thread budget.

The kernel's own source is held to the same outputs too: ``intersect_tris.cu``
is built with g++ through the stub of ``tests/test_torch_sweep_shares.py``,
its ``<<<>>>`` launch rewritten into a loop over the grid's blocks that
runs each block's 128 threads as host threads, and ``__shfl_xor_sync``
exchanging values among the lanes of its mask, which must be the lanes of
the thread's ray. So the entry's dispatch by G, the ray index of each
thread, the lane mask, the butterfly and the store of lane 0 run as
written, at every G, with rays past the last in the last block.
"""
from __future__ import annotations

import os
import re
import subprocess
import warnings

import numpy as np
import pytest
import torch
from _torch_scenes import clustered_soup
from test_torch_sweep_shares import _STUB

from srt_tpu_torch import get_scene
from srt_tpu_torch.kernels import build
from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.render import intersect as ri
from srt_tpu_torch.scene.build import SceneBuilder

torch.set_num_threads(1)

BIG = np.float32(3.0e38)
T_MIN = np.float32(1e-3)


def _cornell(n_rays: int):
    """cornell_boxes' 24 triangles, with half the rays from its camera
    through seeded film points and half from seeded points in the room."""
    scene, cam, _ = get_scene("cornell_boxes", device="cpu")
    r = np.random.default_rng(2)
    h = n_rays // 2
    s, t = (torch.from_numpy(r.random(h).astype(np.float32))
            for _ in range(2))
    o, d, _ = cam.rays(s, t, torch.full((h,), 0.5), torch.full((h,), 0.5),
                       torch.zeros(h))
    o2 = r.uniform((0, 0, 0), (555, 555, 555), (n_rays - h, 3))
    d2 = r.standard_normal((n_rays - h, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return (scene, np.concatenate([o.numpy(), o2]).astype(np.float32),
            np.concatenate([d.numpy(), d2]).astype(np.float32))


def _soup(n_rays: int):
    b, o, d = clustered_soup(SceneBuilder, n_rays)
    return b.build("cpu"), o, d


def _teapot(n_rays: int):
    """teapot_scene at divs=4 (1,984 triangles, the single-level walk), and
    rays from around it towards the teapots."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, _, _ = get_scene("teapot_scene", device="cpu", divs=4)
    assert not ri.two_level(scene)
    r = np.random.default_rng(3)
    lo, hi = scene.bvh_lo[0].numpy(), scene.bvh_hi[0].numpy()
    target = lo + (hi - lo) * r.uniform(size=(n_rays, 3))
    o = (target + r.standard_normal((n_rays, 3)) * 300).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, o, d


CASES = {"cornell": lambda: _cornell(512), "soup": lambda: _soup(400),
         "teapot": lambda: _teapot(400)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    scene, o, d = CASES[request.param]()
    return scene, ki.pack_tables(scene), o, d


def test_records_unpack_to_the_scene_bvh(case):
    """Every node record unpacks to the scene's ``bvh_*`` row and every
    triangle record to ``tri_p0`` and the corners' float32 differences,
    bit for bit; the pad words are 0 and ``count_bits`` holds the widest
    leaf."""
    scene, tb, _, _ = case
    nodes, words = tb["nodes"], tb["nodes"].view(torch.int32)
    assert nodes.shape == (scene.n_bvh_nodes, 8)
    assert torch.equal(nodes[:, 0:3], scene.bvh_lo)
    assert torch.equal(nodes[:, 4:7], scene.bvh_hi)
    assert torch.equal(words[:, 3], scene.bvh_skip)
    bits = tb["count_bits"]
    assert bits == int(scene.bvh_count.max()).bit_length()
    assert torch.equal(words[:, 7] >> bits, scene.bvh_first)
    assert torch.equal(words[:, 7] & ((1 << bits) - 1), scene.bvh_count)
    assert torch.equal(words[:, 7] < 0, scene.bvh_first < 0)
    tris = tb["tris"]
    assert tris.shape == (scene.n_tris, 12)
    assert torch.equal(tris[:, 0:3], scene.tri_p0)
    for k, p in ((4, scene.tri_p1), (8, scene.tri_p2)):
        assert torch.equal(tris[:, k:k + 3].view(torch.int32),
                           (p - scene.tri_p0).view(torch.int32))
    assert not bool(tris[:, 3::4].any())


def _slab(lo, hi, o, inv, t_best):
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    return (tf >= np.maximum(tn, T_MIN)) & (tn < t_best)


def _cross(a, b):
    return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _tri_test(tris, k, lane, o, d, hit):
    """``tri_bvh.cuh:tri_test`` of record ``k`` on the rays of ``lane``,
    in numpy float32: ``hit`` (t, u, v, idx) updated where strictly
    nearer."""
    one = np.float32(1.0)
    p0, e1, e2 = tris[k, 0:3], tris[k, 4:7], tris[k, 8:11]
    pv = _cross(d, e2)
    det = _dot(e1, pv)
    inv_det = one / np.where(np.abs(det) < np.float32(1e-12),
                             np.float32(1e-12), det)
    tv = o - p0
    u = _dot(tv, pv) * inv_det
    qv = _cross(tv, e1)
    v = _dot(d, qv) * inv_det
    t = _dot(e2, qv) * inv_det
    t_best, u_best, v_best, idx = hit
    better = lane & (np.abs(det) > np.float32(1e-10)) & (u >= 0) \
        & (v >= 0) & (u + v <= one) & (t > T_MIN) & (t < t_best)
    return (np.where(better, t, t_best), np.where(better, u, u_best),
            np.where(better, v, v_best), np.where(better, k, idx))


def _fold(shares: list) -> list:
    """``intersect_tris.cu:fold_shares``: the butterfly over the G shares
    of every ray, each share taking its partner's hit when it is nearer,
    or as near with a lower index."""
    g = len(shares)
    m = 1
    while m < g:
        nxt = []
        for p in range(g):
            (t, u, v, idx), (tq, uq, vq, iq) = shares[p], shares[p ^ m]
            take = (tq < t) | ((tq == t) & (iq < idx))
            nxt.append(tuple(np.where(take, a, b) for a, b in
                             ((tq, t), (uq, u), (vq, v), (iq, idx))))
        shares = nxt
        m *= 2
    return shares


def walk_split(tb: dict, o: np.ndarray, d: np.ndarray, g: int):
    """``csrc/intersect_tris.cu``'s walk over the packed records with ``g``
    threads a ray, in numpy float32, every ray one node a round:
    ``(t, u, v, idx)`` and each ray's node visits and triangle tests."""
    nodes = tb["nodes"].numpy()
    words = tb["nodes"].view(torch.int32).numpy().astype(np.int64)
    tris, bits = tb["tris"].numpy(), tb["count_bits"]
    n, n_nodes = o.shape[0], nodes.shape[0]
    inv = np.float32(1.0) / np.where(np.abs(d) < np.float32(1e-20),
                                     np.float32(1e-20), d)
    hit = (np.full(n, BIG, np.float32), np.zeros(n, np.float32),
           np.zeros(n, np.float32), np.zeros(n, np.int64))
    c = np.zeros(n, np.int64)
    visits, tests = np.zeros(n, np.int64), np.zeros(n, np.int64)
    while True:
        act = c < n_nodes
        if not act.any():
            return (*hit, visits, tests)
        cur = np.minimum(c, n_nodes - 1)
        box = act & _slab(nodes[cur, 0:3], nodes[cur, 4:7], o, inv, hit[0])
        skip, link = words[cur, 3], words[cur, 7]
        first, count = link >> bits, link & ((1 << bits) - 1)
        leaf = box & (link >= 0)
        shares = []
        for p in range(g):
            h = hit
            for j in range(p, int(count[leaf].max()) if leaf.any() else 0,
                           g):
                lane = leaf & (j < count)
                h = _tri_test(tris, np.where(lane, first + j, 0), lane, o,
                              d, h)
                tests += lane
            shares.append(h)
        shares = _fold(shares)
        for h in shares[1:]:      # every lane of the ray ends the same
            for a, b in zip(h, shares[0]):
                assert np.array_equal(a.view(np.int32) if a.dtype ==
                                      np.float32 else a, b.view(np.int32)
                                      if b.dtype == np.float32 else b)
        hit = shares[0]
        visits += act
        c = np.where(act, np.where(box & (link < 0), c + 1, skip), c)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_split_walk_matches_plain_walk(case, g):
    """:func:`walk_split` at G finds what the plain walk finds, to the bit,
    visits the nodes it visits and tests the triangles it tests."""
    scene, tb, o, d = case
    t, u, v, idx, visits, tests = walk_split(tb, o, d, g)
    pt, pu, pv, pidx, pvisits, ptests = ri.intersect_tris(
        scene, torch.from_numpy(o), torch.from_numpy(d), stats=True)
    hit = pt.numpy() < 3e38
    assert hit.sum() >= 50 and not hit.all()
    for a, b in ((t, pt), (u, pu), (v, pv)):
        np.testing.assert_array_equal(a.view(np.int32),
                                      b.numpy().view(np.int32))
    np.testing.assert_array_equal(idx, pidx.numpy())
    np.testing.assert_array_equal(visits, pvisits.numpy())
    np.testing.assert_array_equal(tests, ptests.numpy())


def _leaf_ties():
    """Two copies of a triangle in one leaf and a third in a later one,
    with rays that meet them: ``(scene, o, d)`` and the plain walk's
    ``(t, idx)``, which take the first copy in walk order."""
    b = SceneBuilder()
    m = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    tri = np.array([[-1.0, -1.0, 4.0], [1.0, -1.0, 4.0], [0.0, 1.0, 4.0]])
    far = tri + np.array([0.0, 0.0, 3.0])
    b.triangles(np.stack([far, tri, tri, far + 1.0, tri]).astype(np.float32),
                m)
    scene = b.build("cpu")
    r = np.random.default_rng(4)
    o = np.zeros((64, 3), np.float32)
    d = np.concatenate([r.uniform(-0.15, 0.15, (64, 2)),
                        np.ones((64, 1))], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pt, _, _, pidx = ri.intersect_tris(scene, torch.from_numpy(o),
                                       torch.from_numpy(d))
    near = pt.numpy() < 5.0          # the rays that meet the tied copies
    assert near.mean() > 0.5
    tied = scene.tri_p0.numpy()[:, 2] == 4.0
    assert tied.sum() == 3
    first = int(np.flatnonzero(tied)[0])
    assert (pidx.numpy()[near] == first).all()
    return scene, o, d, pt.numpy(), pidx.numpy()


def test_leaf_ties_keep_the_first_triangle_in_walk_order():
    """Every hit on the tied copies takes the first copy in walk order at
    every G, as the plain walk's strict ``<`` does."""
    scene, o, d, pt, pidx = _leaf_ties()
    tb = ki.pack_tables(scene)
    for g in (1, 2, 4):
        t, _, _, idx, _, _ = walk_split(tb, o, d, g)
        np.testing.assert_array_equal(idx, pidx)
        np.testing.assert_array_equal(t.view(np.int32), pt.view(np.int32))


@pytest.mark.parametrize("n_rays,bits,want", [
    (65536, 3, 2), (16384, 3, 4), (16384, 2, 2), (16384, 1, 1),
    (1 << 17, 3, 1), (1 << 15, 3, 4), (100, 3, 4), (100, 2, 2)])
def test_walk_shares_keep_within_the_leaf_and_the_budget(n_rays, bits,
                                                         want):
    """The host's G for B3: the most of ``WALK_SHARES`` with rays times G
    within ``WALK_THREADS``, and no more shares than the widest leaf's
    triangles (a leaf of count < ``1 << bits``)."""
    assert ki.WALK_THREADS == 1 << 17 and ki.WALK_SHARES == (1, 2, 4)
    assert ki.walk_shares(n_rays, bits) == want


# The stub's single-threaded index registers, replaced by a thread's own
_ONE_THREAD = "inline Dim3 threadIdx{0, 0, 0}, blockDim{1, 1, 1};"

_THREADS = r"""
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <mutex>
#include <thread>
#include <vector>
inline thread_local Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0};
inline Dim3 blockDim{1, 1, 1};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// One warp of a block: the lanes named by a shuffle's mask meet there
struct SrtWarp {
  struct Round {
    unsigned arrived = 0;
    unsigned long gen = 0;
    unsigned in[32], out[32];
  };
  std::mutex m;
  std::condition_variable cv;
  std::map<unsigned, Round> rounds;   // by mask
};
inline thread_local SrtWarp* srt_warp = nullptr;
inline unsigned srt_group = 1;   // the threads of one ray

template <class T>
T __shfl_xor_sync(unsigned mask, T v, int m) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const unsigned lane = threadIdx.x % 32, src = lane ^ (unsigned)m;
  const unsigned ray = ((1u << srt_group) - 1u)
                       << (lane / srt_group * srt_group);
  if (mask != ray || !(mask >> src & 1u)) {
    std::fprintf(stderr, "lane %u: mask %x, its ray's lanes %x, from %u\n",
                 lane, mask, ray, src);
    std::abort();
  }
  SrtWarp& w = *srt_warp;
  std::unique_lock<std::mutex> lock(w.m);
  SrtWarp::Round& r = w.rounds[mask];
  std::memcpy(&r.in[lane], &v, 4);
  r.arrived |= 1u << lane;
  const unsigned long gen = r.gen;
  if (r.arrived == mask) {
    std::memcpy(r.out, r.in, sizeof r.in);
    r.arrived = 0;
    ++r.gen;
    w.cv.notify_all();
  } else if (!w.cv.wait_for(lock, std::chrono::seconds(30),
                            [&] { return r.gen != gen; })) {
    std::fprintf(stderr, "lane %u: lanes %x never came\n", lane,
                 mask & ~r.arrived);
    std::abort();
  }
  T x;
  std::memcpy(&x, &r.out[src], 4);
  return x;
}

// A launch of blocks x threads: each block's threads run as host threads
template <class F>
void srt_launch(int blocks, int threads, F body) {
  blockDim = {(unsigned)threads, 1, 1};
  for (int b = 0; b < blocks; ++b) {
    std::vector<SrtWarp> warps((threads + 31) / 32);
    std::vector<std::thread> ts;
    for (int x = 0; x < threads; ++x)
      ts.emplace_back([&, b, x] {
        blockIdx = {(unsigned)b, 0, 0};
        threadIdx = {(unsigned)x, 0, 0};
        srt_warp = &warps[x / 32];
        body();
      });
    for (std::thread& t : ts) t.join();
  }
}
"""

# Reads "in.bin" (int32 n_nodes, n_tris, n_rays, count_bits, G; float32
# nodes (n_nodes, 8), tris (n_tris, 12), o (n_rays, 3), d (n_rays, 3)),
# calls the kernel's entry and writes "out.bin": per ray the int32 words
# t, u, v (bit patterns) and idx. Exits 10 + the entry's error code, or 3
# when a store went past the last ray.
_WALK_PROGRAM = r"""
#include "walk.cu"

int main() {
  std::FILE* f = std::fopen("in.bin", "rb");
  int h[5];
  if (std::fread(h, 4, 5, f) != 5) return 1;
  const int n_nodes = h[0], n_tris = h[1], n = h[2], pad = 256;
  std::vector<float> nodes(8 * n_nodes), tris(12 * n_tris), o(3 * n),
      d(3 * n);
  for (std::vector<float>* v : {&nodes, &tris, &o, &d})
    if (std::fread(v->data(), 4, v->size(), f) != v->size()) return 1;
  std::fclose(f);
  std::vector<float> t(n + pad, -7.0f), u(n + pad, -7.0f), v(n + pad, -7.0f);
  std::vector<int> idx(n + pad, -7);
  const IntersectTrisArgs a{
      o.data(), d.data(), (const float4*)nodes.data(),
      (const float4*)tris.data(), t.data(), u.data(), v.data(), idx.data(),
      n, n_nodes, h[3], h[4]};
  srt_group = (unsigned)h[4];
  const int rc = srt_intersect_tris(&a, nullptr);
  if (rc) return 10 + rc;
  for (int i = n; i < n + pad; ++i)
    if (t[i] != -7.0f || u[i] != -7.0f || v[i] != -7.0f || idx[i] != -7)
      return 3;
  std::vector<int> out;
  for (int i = 0; i < n; ++i) {
    out.push_back(__float_as_int(t[i]));
    out.push_back(__float_as_int(u[i]));
    out.push_back(__float_as_int(v[i]));
    out.push_back(idx[i]);
  }
  f = std::fopen("out.bin", "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
}
"""


@pytest.fixture(scope="module")
def kernel_walk(tmp_path_factory):
    """A function ``(tables, o, d, g) -> (returncode, t, u, v, idx)`` that
    runs ``csrc/intersect_tris.cu``'s entry, built with g++, at ``g``
    threads a ray."""
    work = tmp_path_factory.mktemp("tri_walk")
    assert _ONE_THREAD in _STUB
    (work / "cuda_runtime.h").write_text(_STUB.replace(_ONE_THREAD,
                                                       _THREADS))
    csrc = os.path.dirname(build.SOURCES[0])
    with open(os.path.join(csrc, "intersect_tris.cu")) as f:
        src, n_launch = re.subn(
            r"(\w+<G>)<<<(\w+), (\w+), 0, \w+>>>\((\w+)\);",
            r"srt_launch(\2, \3, [&] { \1(\4); });", f.read())
    assert n_launch == 1
    (work / "walk.cu").write_text(src)
    (work / "walk.cpp").write_text(_WALK_PROGRAM)
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-pthread", "-I", str(work),
                    "-I", csrc, "-o", str(work / "walk"),
                    str(work / "walk.cpp")], check=True)

    def run(tb, o, d, g):
        nodes, tris = (tb[k].numpy() for k in ("nodes", "tris"))
        head = np.array([len(nodes), len(tris), len(o), tb["count_bits"], g],
                        np.int32)
        (work / "in.bin").write_bytes(head.tobytes() + b"".join(
            np.ascontiguousarray(a, np.float32).tobytes()
            for a in (nodes, tris, o, d)))
        rc = subprocess.run([str(work / "walk")], cwd=work).returncode
        if rc:
            return rc, None
        out = np.fromfile(work / "out.bin", np.int32).reshape(len(o), 4)
        return 0, (*(out[:, k].view(np.float32) for k in range(3)),
                   out[:, 3])
    return run


@pytest.mark.parametrize("g", [1, 2, 4])
def test_kernel_source_walk_matches_plain_walk(case, g, kernel_walk):
    """``intersect_tris.cu`` itself, run on host threads at G, finds the
    plain walk's ``(t, u, v, idx)`` to the bit and stores nothing past the
    last ray."""
    scene, tb, o, d = case
    rc, got = kernel_walk(tb, o, d, g)
    assert rc == 0, f"the kernel's program exited {rc}"
    pt, pu, pv, pidx = ri.intersect_tris(scene, torch.from_numpy(o),
                                         torch.from_numpy(d))
    assert (pt.numpy() < 3e38).sum() >= 50
    for a, b in zip(got[:3], (pt, pu, pv)):
        np.testing.assert_array_equal(a.view(np.int32),
                                      b.numpy().view(np.int32))
    np.testing.assert_array_equal(got[3], pidx.numpy())


def test_kernel_source_refuses_other_shares(kernel_walk):
    """The entry launches nothing at a G it has no walk for and returns
    ``cudaErrorInvalidValue``."""
    scene, o, d = _cornell(64)
    assert kernel_walk(ki.pack_tables(scene), o, d, 3)[0] == 10 + 1


@pytest.mark.parametrize("g", [1, 2, 4])
def test_kernel_source_leaf_ties_keep_the_first_triangle(g, kernel_walk):
    """``intersect_tris.cu`` itself takes the first of the tied copies in
    walk order at G, whichever thread tested it."""
    scene, o, d, pt, pidx = _leaf_ties()
    rc, got = kernel_walk(ki.pack_tables(scene), o, d, g)
    assert rc == 0, f"the kernel's program exited {rc}"
    np.testing.assert_array_equal(got[3], pidx)
    np.testing.assert_array_equal(got[0].view(np.int32), pt.view(np.int32))
