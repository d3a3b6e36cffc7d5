"""Closest hits on the triangle family: each ray's nearest Möller–Trumbore
hit over the scene's triangle soup, read in the arrays' own order, ties to
the lowest index.

The test (:func:`tri_test`) and the hit record (:func:`hit_record`) are
frozen copies of ``srt_tpu_torch/render/intersect.py:_tri_intersect`` and
``tri_hit``. The reference reads ``tri_p0``, ``tri_p1``, ``tri_p2``,
``tri_uv``, ``tri_n`` and ``tri_mat``, and nothing that the program
derives from them: no BVH, no clusters.

To afford a million triangles, :func:`closest` prunes by boxes that it
takes from the vertices. The soup, in its own order, is cut into leaves of
``leaf`` triangles and blocks of ``leaf`` leaves. A ray tests a block's
leaves only where its slab entry into the block is at or nearer than its
best hit so far, and a leaf's triangles only where the same holds of the
leaf; "at or nearer" keeps a triangle at exactly the best distance, so the
lowest index still wins a tie. The best so far is the bound the caller
gives (the spheres' and rects' hit), then the hit in the block each ray
enters first. Every box is padded by :data:`PAD` of the soup's largest
coordinate, so a test whose rounded ``t`` lands a little outside its box
is not pruned: a grazing test, whose ``t`` rounding can move farther, is
the one case the pad does not cover. The winner is the least ``(t,
index)`` over the tests run, so the order in which they run does not
matter: :func:`brute_force` runs every test and gives the same hits, to
which the tests hold :func:`closest`.
"""
from __future__ import annotations

import torch

from benchmark.reference.core import cross, dot, normalize
from benchmark.reference.hit import BIG, Hit, ray_at

#: triangles a leaf, and leaves a block
LEAF = 64
#: each box's padding, a share of the soup's largest coordinate
PAD = 1e-4
#: rays a chunk in the block test, (ray, box) pairs a chunk in the leaf and
#: triangle tests: each bounds a temporary of a few tens of MB
RAYS = 1 << 15
PAIRS = 1 << 16
#: the key of a ray that hit nothing: above every ``(t, index)`` key
MISS = torch.iinfo(torch.int64).max


def tri_test(p0, e1, e2, o, d, t_min, t_max):
    """Möller–Trumbore of rays ``(o, d)`` against triangles ``p0`` with
    edges ``e1 = p1 - p0`` and ``e2 = p2 - p0``, all broadcasting over
    ``(..., 3)``: returns ``(t, u, v, valid)`` (the port's math and guards,
    ``intersect.py:347-369``)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = ((torch.abs(det) > 1e-10) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    return t, u, v, valid


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)


def _slab(lo, hi, o, inv_d, t_min, bound):
    """Each ray's entry into its boxes, ``inf`` where it misses them or
    enters beyond ``bound``; ``o``, ``inv_d`` broadcast against ``lo``,
    ``hi`` over ``(..., 3)``."""
    tt0 = (lo - o) * inv_d
    tt1 = (hi - o) * inv_d
    tn = torch.minimum(tt0, tt1).amax(-1)
    tf = torch.maximum(tt0, tt1).amin(-1)
    near = (tf >= torch.clamp(tn, min=t_min)) & (tn <= bound)
    return torch.where(near, tn, torch.inf)


def _boxes(lo, hi, leaf: int):
    """The box around each run of ``leaf`` boxes; a short last run is
    filled with copies of its last box, which leave its union as it is."""
    n = lo.shape[0]
    k = -(-n // leaf)
    fill = k * leaf - n
    lo = torch.cat([lo, lo[-1:].expand(fill, 3)])
    hi = torch.cat([hi, hi[-1:].expand(fill, 3)])
    return lo.reshape(k, leaf, 3).amin(1), hi.reshape(k, leaf, 3).amax(1)


class Soup:
    """The triangle arrays on one device, each triangle's edges, and the
    padded boxes of its leaves and blocks."""

    def __init__(self, p0, p1, p2, uv, n, mat, leaf: int = LEAF):
        self.p0, self.e1, self.e2 = p0, p1 - p0, p2 - p0
        self.uv, self.n, self.mat = uv, n, mat
        self.count, self.leaf = p0.shape[0], leaf
        lo = torch.minimum(torch.minimum(p0, p1), p2)
        hi = torch.maximum(torch.maximum(p0, p1), p2)
        pad = PAD * max(float(lo.abs().max()), float(hi.abs().max()), 1.0)
        leaf_lo, leaf_hi = _boxes(lo, hi, leaf)
        self.leaf_lo, self.leaf_hi = leaf_lo - pad, leaf_hi + pad
        self.block_lo, self.block_hi = _boxes(self.leaf_lo, self.leaf_hi,
                                              leaf)


def _key(t, idx):
    """``(t, index)`` as one int64 that orders as the pair does: a
    positive float32's bits order as its value."""
    return (t.view(torch.int32).to(torch.int64) << 32) | idx


def _best_t(key):
    t = (key >> 32).to(torch.int32).view(torch.float32)
    return torch.where(key == MISS, BIG, t)


def _test_leaves(soup, ray, leaf, o, d, t_min, key):
    """Every triangle of leaf ``leaf[i]`` against ray ``ray[i]``; each
    ray's least ``(t, index)`` goes into ``key``."""
    slots = torch.arange(soup.leaf, device=o.device)
    for c0 in range(0, ray.shape[0], PAIRS):
        r = ray[c0:c0 + PAIRS]
        tri = leaf[c0:c0 + PAIRS, None] * soup.leaf + slots
        real = tri < soup.count
        tri = torch.clamp(tri, max=soup.count - 1)
        t, _, _, valid = tri_test(soup.p0[tri], soup.e1[tri], soup.e2[tri],
                                  o[r, None], d[r, None], t_min, BIG)
        t, j = torch.min(torch.where(valid & real, t, BIG), 1)  # first
        hit = t < BIG
        idx = tri.gather(1, j[:, None])[:, 0]
        key.scatter_reduce_(0, r[hit], _key(t[hit], idx[hit]), "amin")


def _test_blocks(soup, ray, block, o, d, inv, t_min, bound, key):
    """The leaves of block ``block[i]`` that ray ``ray[i]`` enters at or
    before ``bound[ray[i]]``, then their triangles."""
    slots = torch.arange(soup.leaf, device=o.device)
    n_leaves = soup.leaf_lo.shape[0]
    for c0 in range(0, ray.shape[0], PAIRS):
        r = ray[c0:c0 + PAIRS]
        lf = block[c0:c0 + PAIRS, None] * soup.leaf + slots
        real = lf < n_leaves
        lf = torch.clamp(lf, max=n_leaves - 1)
        tn = _slab(soup.leaf_lo[lf], soup.leaf_hi[lf], o[r, None],
                   inv[r, None], t_min, bound[r, None])
        i, j = torch.nonzero(real & (tn < torch.inf), as_tuple=True)
        _test_leaves(soup, r[i], lf[i, j], o, d, t_min, key)


def closest(soup: Soup, o, d, t_min: float, bound=None):
    """Each ray's nearest triangle ``(t, u, v, index)``: ``t`` BIG, ``u``
    and ``v`` 0, ``index`` -1 where it hits none. Triangles that ``bound``
    (N,) already beats may be missed: a caller that takes a triangle only
    where it is strictly nearer than ``bound`` loses nothing."""
    n, dev = o.shape[0], o.device
    if bound is None:
        bound = torch.full((n,), BIG, device=dev)
    inv = _safe_inv(d)
    key = torch.full((n,), MISS, dtype=torch.int64, device=dev)
    for r0 in range(0, n, RAYS):
        r1 = min(r0 + RAYS, n)
        rays = torch.arange(r0, r1, device=dev)
        tn = _slab(soup.block_lo, soup.block_hi, o[r0:r1, None],
                   inv[r0:r1, None], t_min, bound[r0:r1, None])
        # the block each ray enters first, then the rest it enters at or
        # before its best hit
        t_first, first = torch.min(tn, 1)
        go = t_first < torch.inf
        _test_blocks(soup, rays[go], first[go], o, d, inv, t_min, bound,
                     key)
        best = torch.minimum(bound, _best_t(key))
        tn[rays[go] - r0, first[go]] = torch.inf
        i, b = torch.nonzero(tn <= best[r0:r1, None], as_tuple=True)
        _test_blocks(soup, rays[i], b, o, d, inv, t_min, best, key)
    return _winner(soup, o, d, t_min, key)


def _winner(soup, o, d, t_min, key):
    """``(t, u, v, index)`` of each ray's key: the winner's test run once
    more, for its ``u`` and ``v``."""
    idx = torch.where(key == MISS, -1, key & 0xFFFFFFFF)
    k = torch.clamp(idx, min=0)
    t, u, v, _ = tri_test(soup.p0[k], soup.e1[k], soup.e2[k], o, d, t_min,
                          BIG)
    hit = idx >= 0
    return (torch.where(hit, t, BIG), torch.where(hit, u, 0.0),
            torch.where(hit, v, 0.0), idx)


def brute_force(soup: Soup, o, d, t_min: float, chunk: int = 256):
    """:func:`closest` by testing every ray against every triangle."""
    n, dev = o.shape[0], o.device
    key = torch.full((n,), MISS, dtype=torch.int64, device=dev)
    rays = torch.arange(n, device=dev)
    for c0 in range(0, soup.count, chunk):
        c1 = min(c0 + chunk, soup.count)
        t, _, _, valid = tri_test(soup.p0[c0:c1], soup.e1[c0:c1],
                                  soup.e2[c0:c1], o[:, None], d[:, None],
                                  t_min, BIG)
        t, j = torch.min(torch.where(valid, t, BIG), 1)
        hit = t < BIG
        key.scatter_reduce_(0, rays[hit], _key(t[hit], j[hit] + c0), "amin")
    return _winner(soup, o, d, t_min, key)


def hit_record(soup: Soup, o, d, t, u, v, idx) -> Hit:
    """The hit record of each ray's triangle (``intersect.py:396-403``):
    barycentric uv, the normalised interpolated shading normal, the
    triangle's material."""
    hit = t < BIG
    w = (1.0 - u - v)[:, None]
    u, v, tri = u[:, None], v[:, None], torch.clamp(idx, min=0)
    uvs, ns = soup.uv[tri], soup.n[tri]
    return Hit(t=torch.where(hit, t, BIG), hit=hit, p=ray_at(o, d, t),
               normal=normalize(ns[:, 0] * w + ns[:, 1] * u + ns[:, 2] * v),
               uv=uvs[:, 0] * w + uvs[:, 1] * u + uvs[:, 2] * v,
               mat=soup.mat[tri].long())


def intersect(soup: Soup, o, d, t_min: float, bound) -> Hit:
    """The triangles' hit record for rays that the other families hit at
    ``bound``."""
    return hit_record(soup, o, d, *closest(soup, o, d, t_min, bound))
