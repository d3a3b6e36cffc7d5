"""Kernel B4's records and walk, on the CPU: the 16-byte-aligned tables of
``kernels/intersect.py:pack_big_tables`` and the single-loop walk of
``csrc/intersect_big.cu``.

The tables must hold what the scene's two-level BVH holds (``top_*`` and
``cl_*`` in the JAX package's layout), bit for bit, without the padding
to the TPU's block size. :func:`walk_records` steps through the kernel's
state machine in numpy, every ray one record a round as the kernel's
threads do: the phase bit, the cluster's row and the top skip to resume
at. It must find what the plain two-level walk finds and visit the
records that walk visits, in the same order, less the padding node the
plain walk reads at the end of each cluster shorter than its cap.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch
from _torch_scenes import clustered_soup

from srt_tpu_torch import get_scene
from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.render import intersect as ri
from srt_tpu_torch.scene.build import SceneBuilder

torch.set_num_threads(1)

BIG = np.float32(3.0e38)
T_MIN = np.float32(1e-3)


def _soup(n_rays: int):
    b, o, d = clustered_soup(SceneBuilder, n_rays)
    return b.build("cpu"), o, d


def _teapot(n_rays: int):
    """teapot_scene at divs=8 with the builder's caps (2,048 nodes, 4,096
    triangles a cluster), and rays from its camera's region towards the
    teapots."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, _, _ = get_scene("teapot_scene", device="cpu", divs=8)
    r = np.random.default_rng(3)
    lo, hi = scene.top_lo[0].numpy(), scene.top_hi[0].numpy()
    target = lo + (hi - lo) * r.uniform(size=(n_rays, 3))
    o = (target + r.standard_normal((n_rays, 3)) * 300).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, o, d


CASES = {"soup": lambda: _soup(400), "teapot": lambda: _teapot(400)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    scene, o, d = CASES[request.param]()
    return scene, ki.pack_big_tables(scene), o, d


def _unlink(words: np.ndarray, bits: int):
    return words >> bits, words & ((1 << bits) - 1)


def test_records_unpack_to_the_scene_fields(case):
    """Every record unpacks to the scene's ``top_*`` and ``cl_*`` fields
    bit for bit: the top tree row for row, each cluster's real nodes and
    triangles in order from its bases, and nothing of a cluster beyond
    its node and triangle counts but padding."""
    scene, tb, _, _ = case
    top = tb["top"]
    assert torch.equal(top[:, 0:3], scene.top_lo)
    assert torch.equal(top[:, 4:7], scene.top_hi)
    words = top.view(torch.int32)
    assert torch.equal(words[:, 3], scene.top_skip)
    assert torch.equal(words[:, 7], scene.top_cluster)

    rec = ri.cluster_records(scene)
    cap, tcap = rec["node_cap"], rec["tri_cap"]
    cl = tb["clusters"].numpy()
    nodes, nw = tb["nodes"].numpy(), tb["nodes"].view(torch.int32).numpy()
    n_cl = scene.cl_tris.shape[0]
    assert cl.shape == (n_cl, 4) and n_cl >= 2
    tri_base = dict(zip(scene.top_cluster.tolist(),
                        scene.top_tri_base.tolist()))
    node_base = tri_off = 0
    for c in range(n_cl):
        nb, tb_, base, nn = cl[c]
        assert (nb, tb_) == (node_base, tri_off) and base == tri_base[c]
        g = slice(c * cap, c * cap + nn)
        np.testing.assert_array_equal(nodes[nb:nb + nn, 0:3],
                                      rec["lo"][g].numpy())
        np.testing.assert_array_equal(nodes[nb:nb + nn, 4:7],
                                      rec["hi"][g].numpy())
        np.testing.assert_array_equal(nw[nb:nb + nn, 3], rec["skip"][g])
        first, count = _unlink(nw[nb:nb + nn, 7], tb["count_bits"])
        np.testing.assert_array_equal(first, rec["first"][g])
        np.testing.assert_array_equal(count, rec["count"][g])
        # past the last node: the padding the walk no longer visits
        pad = slice(c * cap + nn, (c + 1) * cap)
        assert bool((rec["skip"][pad] == cap).all())
        assert not bool(rec["lo"][pad].any() or rec["hi"][pad].any())
        ntri = int((first + count).max())
        tris = tb["tris"][tri_off:tri_off + ntri].numpy()
        p = rec["p"][c * tcap:(c + 1) * tcap].numpy()
        np.testing.assert_array_equal(tris[:, 0:3], p[:ntri, 0:3])
        assert not p[ntri:].any()
        node_base += nn
        tri_off += ntri
    assert (node_base, tri_off) == (nodes.shape[0], tb["tris"].shape[0])
    assert tri_off == scene.n_tris


def test_edges_are_the_vertex_differences(case):
    """``e1``, ``e2`` equal ``p1 - p0``, ``p2 - p0`` bit for bit, and each
    triangle record holds the scene's triangle ``tri_base + k``; the pad
    words are 0."""
    scene, tb, _, _ = case
    tris = tb["tris"]
    glob = torch.cat([torch.arange(int(b), int(b) + n) for b, n in zip(
        tb["clusters"][:, 2], torch.diff(torch.cat([
            tb["clusters"][:, 1], torch.tensor([tris.shape[0]])])))])
    p0, p1, p2 = (scene.tri_p0[glob], scene.tri_p1[glob], scene.tri_p2[glob])
    assert torch.equal(tris[:, 0:3], p0)
    assert torch.equal(tris[:, 4:7].view(torch.int32),
                       (p1 - p0).view(torch.int32))
    assert torch.equal(tris[:, 8:11].view(torch.int32),
                       (p2 - p0).view(torch.int32))
    assert not bool(tris[:, 3::4].any())


@pytest.mark.parametrize("first,count,bits,fits", [
    (5, 4, 3, True), (-1, 0, 3, True), ((1 << 28) - 1, 7, 3, True),
    (1 << 28, 1, 3, False), (3, 8, 3, False), (-2, 0, 3, False),
    ((1 << 30) - 1, 1, 1, True), (1 << 30, 1, 1, False)])
def test_link_words_reject_counts_that_do_not_fit(first, count, bits, fits):
    """A link word holds ``first << bits | count``; a first triangle or a
    count beyond its bits raises instead of wrapping."""
    f, c = torch.tensor([first]), torch.tensor([count])
    if not fits:
        with pytest.raises(ValueError, match="do not fit"):
            ki.link_words(f, c, bits)
        return
    w = ki.link_words(f, c, bits)
    assert w.dtype == torch.int32 and (int(w) < 0) == (first < 0)
    assert _unlink(w.numpy(), bits) == (first, count)


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


def walk_records(tb: dict, o: np.ndarray, d: np.ndarray, node_cap: int):
    """``csrc/intersect_big.cu``'s loop over the packed records, in numpy
    float32, every ray one record a round: ``(t, u, v, idx)`` and each
    ray's top-tree visits, cluster-node visits and the clusters it entered
    that hold fewer than ``node_cap`` nodes."""
    top, nodes = tb["top"].numpy(), tb["nodes"].numpy()
    top_w, node_w = tb["top"].view(torch.int32).numpy(), \
        tb["nodes"].view(torch.int32).numpy()
    tris, cl_tab = tb["tris"].numpy(), tb["clusters"].numpy()
    bits = tb["count_bits"]
    n, n_top = o.shape[0], top.shape[0]
    one = np.float32(1.0)
    inv = one / np.where(np.abs(d) < np.float32(1e-20), np.float32(1e-20), d)
    t = np.full(n, BIG, np.float32)
    u, v = np.zeros(n, np.float32), np.zeros(n, np.float32)
    idx = np.zeros(n, np.int64)
    inside = np.zeros(n, bool)
    c, resume = np.zeros(n, np.int64), np.zeros(n, np.int64)
    cl = np.zeros((n, 4), np.int64)
    top_v, cl_v, entered = (np.zeros(n, np.int64) for _ in range(3))
    while True:
        act = inside | (c < n_top)
        if not act.any():
            return t, u, v, idx, top_v, cl_v, entered
        rn = np.where(inside, cl[:, 0] + c, 0)
        rt = np.where(inside, 0, np.minimum(c, n_top - 1))
        rec = np.where(inside[:, None], nodes[rn], top[rt])
        w = np.where(inside[:, None], node_w[rn], top_w[rt])
        box = act & _slab(rec[:, 0:3], rec[:, 4:7], o, inv, t)
        skip, link = w[:, 3].astype(np.int64), w[:, 7].astype(np.int64)
        top_v += act & ~inside
        cl_v += inside
        # a cluster leaf's triangles, at most the widest leaf a round
        first, count = _unlink(link, bits)
        leaf = inside & box & (link >= 0)
        for j in range(int(count[leaf].max()) if leaf.any() else 0):
            lane = leaf & (j < count)
            k = np.where(lane, cl[:, 1] + first + j, 0)
            p0, e1, e2 = tris[k, 0:3], tris[k, 4:7], tris[k, 8:11]
            pv = _cross(d, e2)
            det = _dot(e1, pv)
            inv_det = one / np.where(np.abs(det) < np.float32(1e-12),
                                     np.float32(1e-12), det)
            tv = o - p0
            uu = _dot(tv, pv) * inv_det
            qv = _cross(tv, e1)
            vv = _dot(d, qv) * inv_det
            tt = _dot(e2, qv) * inv_det
            better = lane & (np.abs(det) > np.float32(1e-10)) & (uu >= 0) \
                & (vv >= 0) & (uu + vv <= one) & (tt > T_MIN) & (tt < t)
            t, u, v = (np.where(better, a, b) for a, b in ((tt, t), (uu, u),
                                                           (vv, v)))
            idx = np.where(better, cl[:, 2] + first + j, idx)
        nxt = np.where(box & (link < 0), c + 1, skip)
        # inside: the next node, or back to the top tree past the cluster
        leave = inside & (nxt >= cl[:, 3])
        enter = act & ~inside & box & (link >= 0)
        row = cl_tab[np.where(enter, link, 0)]
        c = np.where(leave, resume, np.where(enter, 0, np.where(act, nxt, c)))
        resume = np.where(enter, skip, resume)
        cl = np.where(enter[:, None], row, cl)
        entered += enter & (row[:, 3] < node_cap)
        inside = (inside & ~leave) | enter


def test_single_loop_walk_matches_plain_walk(case):
    """:func:`walk_records` finds what the plain two-level walk finds, to
    the bit, and visits what it visits: the same top-tree visits, and its
    cluster-node visits less the padding node the plain walk reads in each
    cluster shorter than its cap that the ray walked."""
    scene, tb, o, d = case
    t, u, v, idx, top_v, cl_v, short = walk_records(
        tb, o, d, ri.cluster_records(scene)["node_cap"])
    pt, pu, pv, pidx, ptop, pcl, _, _ = ri.intersect_tris_big(
        scene, torch.from_numpy(o), torch.from_numpy(d), stats=True)
    hit = pt.numpy() < 3e38
    assert hit.mean() > 0.2
    for a, b in ((t, pt), (u, pu), (v, pv)):
        np.testing.assert_array_equal(a.view(np.int32),
                                      b.numpy().view(np.int32))
    np.testing.assert_array_equal(idx, pidx.numpy())
    np.testing.assert_array_equal(top_v, ptop.numpy())
    np.testing.assert_array_equal(cl_v, pcl.numpy() - short)
    assert short.sum() > 0
