"""Two-level BVH clustering (a copy of ``srt_tpu/accel/cluster.py:36-171``)
for the two-level walk, kernel B4.

The flat skip-link BVH (:class:`srt_tpu_torch.accel.bvh.FlatBVH`) is cut
into

* a small **top-level tree** whose leaves are *clusters*: subtrees whose
  node and triangle counts fit fixed caps, and
* per-cluster **node and triangle blocks**, padded to the caps and laid
  out one after another.

The depth-first skip-link layout makes the cut simple: a subtree rooted at
``n`` holds the contiguous node range ``[n, skip[n])`` and a contiguous
triangle range, so a cluster is a node slice with re-based skip links plus
a triangle slice. The arrays equal the JAX package's bit for bit at the
same caps; the scene builder's caps are 2,048 nodes and 4,096 triangles
(``srt_tpu/scene/build.py:47-48``), and so are this module's defaults.

Host-side numpy, run once at scene build.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from srt_tpu_torch.accel.bvh import FlatBVH

NODE_CAP = 2048           # 16 rows of 128
TRI_CAP = 4096            # 32 rows of 128


class ClusteredBVH(NamedTuple):
    # top-level skip-link tree; its leaves point at clusters
    top_lo: np.ndarray        # (Bt, 3) f32
    top_hi: np.ndarray        # (Bt, 3) f32
    top_skip: np.ndarray      # (Bt,) i32
    top_cluster: np.ndarray   # (Bt,) i32 cluster id of a leaf, -1 inner
    top_tri_base: np.ndarray  # (Bt,) i32 first global triangle of the
                              #   leaf's cluster, 0 inner
    # cluster blocks padded to the caps, in the JAX package's plane layout:
    # nodes f: lo.x lo.y lo.z hi.x hi.y hi.z  -> (Nc, 6, node_cap//128, 128)
    # nodes i: skip first count               -> (Nc, 3, node_cap//128, 128)
    # tris:    p0.xyz p1.xyz p2.xyz           -> (Nc, 9, tri_cap//128, 128)
    cl_nodes_f: np.ndarray
    cl_nodes_i: np.ndarray
    cl_tris: np.ndarray

    @property
    def n_clusters(self) -> int:
        return self.cl_tris.shape[0]

    @property
    def n_top(self) -> int:
        return self.top_skip.shape[0]


def _plane(x: np.ndarray, cap: int, dtype) -> np.ndarray:
    out = np.zeros((cap,), dtype)
    out[: x.shape[0]] = x
    return out.reshape(cap // 128, 128)


def build_clusters(bvh: FlatBVH, tri_p0: np.ndarray, tri_p1: np.ndarray,
                   tri_p2: np.ndarray, node_cap: int = NODE_CAP,
                   tri_cap: int = TRI_CAP) -> ClusteredBVH:
    """Partition ``bvh`` (triangles already in BVH order) into clusters."""
    n = bvh.skip.shape[0]
    skip, first, count = bvh.skip, bvh.first, bvh.count

    # node i's subtree is [i, skip[i]); leaves are emitted in DFS order, so
    # its triangles are [pref[i], pref[i] + sub_tris[i])
    is_leaf = first >= 0
    leaf_counts = np.where(is_leaf, count, 0)
    pref = np.concatenate([[0], np.cumsum(leaf_counts)])  # (n+1,)
    sub_tris = pref[skip] - pref[np.arange(n)]
    sub_nodes = skip - np.arange(n)
    tri_begin = pref[:n]

    # cut nodes: an iterative DFS; the children of i are i+1 and skip[i+1]
    cuts: list[int] = []
    stack = [0]
    while stack:
        i = stack.pop()
        if sub_nodes[i] <= node_cap and sub_tris[i] <= tri_cap:
            cuts.append(i)
            continue
        left = i + 1
        right = skip[left]
        stack.append(int(right))
        stack.append(int(left))
    cuts_arr = np.sort(np.asarray(cuts, np.int64))
    nc = len(cuts_arr)

    # cluster blocks
    rows_n, rows_t = node_cap // 128, tri_cap // 128
    cl_f = np.zeros((nc, 6, rows_n, 128), np.float32)
    cl_i = np.zeros((nc, 3, rows_n, 128), np.int32)
    cl_t = np.zeros((nc, 9, rows_t, 128), np.float32)
    for ci, root in enumerate(cuts_arr):
        lo_n, hi_n = int(root), int(skip[root])
        t0 = int(tri_begin[root])
        nn = hi_n - lo_n
        # local ids; a skip past the subtree becomes nn, the first padding
        # node, whose own skip (node_cap) ends the walk
        l_skip = np.minimum(skip[lo_n:hi_n] - lo_n, nn)
        l_first = np.where(first[lo_n:hi_n] >= 0,
                           first[lo_n:hi_n] - t0, -1)
        for a in range(3):
            cl_f[ci, a] = _plane(bvh.lo[lo_n:hi_n, a], node_cap, np.float32)
            cl_f[ci, 3 + a] = _plane(bvh.hi[lo_n:hi_n, a], node_cap,
                                     np.float32)
        pad_skip = np.full((node_cap,), node_cap, np.int32)
        pad_skip[:nn] = l_skip
        cl_i[ci, 0] = pad_skip.reshape(rows_n, 128)
        cl_i[ci, 1] = _plane(l_first, node_cap, np.int32)
        cl_i[ci, 2] = _plane(count[lo_n:hi_n], node_cap, np.int32)
        t1 = t0 + int(sub_tris[root])
        for a in range(3):
            cl_t[ci, 0 + a] = _plane(tri_p0[t0:t1, a], tri_cap, np.float32)
            cl_t[ci, 3 + a] = _plane(tri_p1[t0:t1, a], tri_cap, np.float32)
            cl_t[ci, 6 + a] = _plane(tri_p2[t0:t1, a], tri_cap, np.float32)

    # the top-level tree: the original tree with each cut subtree a leaf
    cut_set = {int(c) for c in cuts_arr}
    old2new: dict[int, int] = {}
    t_lo, t_hi, t_skip_old, t_cluster, t_base = [], [], [], [], []
    i = 0
    while i < n:
        old2new[i] = len(t_lo)
        t_lo.append(bvh.lo[i])
        t_hi.append(bvh.hi[i])
        t_skip_old.append(int(skip[i]))   # old id; remapped below
        if i in cut_set:
            t_cluster.append(int(np.searchsorted(cuts_arr, i)))
            t_base.append(int(tri_begin[i]))
            i = int(skip[i])              # past the whole subtree
        else:
            t_cluster.append(-1)
            t_base.append(0)
            i += 1
    old2new[n] = len(t_lo)
    top_skip = np.asarray([old2new[s] for s in t_skip_old], np.int32)

    return ClusteredBVH(
        top_lo=np.asarray(t_lo, np.float32).reshape(-1, 3),
        top_hi=np.asarray(t_hi, np.float32).reshape(-1, 3),
        top_skip=top_skip,
        top_cluster=np.asarray(t_cluster, np.int32),
        top_tri_base=np.asarray(t_base, np.int32),
        cl_nodes_f=cl_f, cl_nodes_i=cl_i, cl_tris=cl_t)
