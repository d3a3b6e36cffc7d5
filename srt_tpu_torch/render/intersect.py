"""Closest-hit intersection over spheres, rects and triangles
(counterpart of ``srt_tpu/render/intersect.py:39-565``).

Spheres and rects: a dense sweep over primitive chunks, the JAX package's
default for sphere scenes. Ties keep the lowest index. A sphere is at its
centre at the ray's time (``moving_sphere.h:19-21``), the lerp factor
taken with the reciprocal of the shutter span as the kernels' tables hold
it (the JAX package's XLA sweep divides). :func:`sphere_winner` is the
plain version of kernel B6, each ray's winning sphere ``(t, idx)`` only;
:func:`assemble_sphere_hit` re-derives the winner's hit differentiably,
so geometry gradients flow through the one winning sphere while the
winner itself is detached (``intersect.py:91-140``).

Triangles: :func:`intersect_tris` is the plain version of kernel B3, the
per-ray stackless skip-link walk over the scene's BVH with
Möller–Trumbore tests (``intersect.py:347-498``), every ray's cursor
advanced in lockstep until all have left the tree.
:func:`intersect_tris_big` is the plain version of kernel B4, the same
walk over the two-level BVH (a top tree whose leaves are clusters,
``accel/cluster.py``). :func:`intersect_tris_any` picks one by the JAX
package's rule (:func:`two_level`). A triangle wins only when strictly
nearer than the spheres' and rects' best hit.

The sphere BVH: :func:`intersect_spheres_bvh` walks the scene's
skip-link tree over its spheres (``sbvh_*``, built from 64 spheres on) in
place of the sweep when the render turns it on (``SceneFlags.sphere_bvh``,
off by default, as the JAX package's ``SRT_TPU_SPHERE_BVH`` is). JAX
computes that walk in XLA, not in a Pallas kernel, so it is plain torch
here too.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from srt_tpu_torch.core.gradsafe import gsdiv
from srt_tpu_torch.core.vecmath import cross, dot, normalize, safe_sqrt
from srt_tpu_torch.scene.ir import TorchScene

BIG = 3.0e38
T_POS_MAX = 1.0e7    # position-eval clamp: o + BIG*d would overflow
PRIM_CHUNK = 128
#: mesh bytes (36 a node, 36 a triangle) above which a scene takes the
#: two-level walk: the JAX package's VMEM budget for its single-level
#: kernel (``srt_tpu/pallas/intersect.py:48``), kept so that the same
#: scenes take the same walk in both packages
SINGLE_LEVEL_BUDGET = 6 * 1024 * 1024

# Per-rect-axis component indices (aarect.h:96-147): plane normal axis,
# and the two in-plane axes (u, v).
RECT_NAXIS = (2, 1, 0)   # xy->z, xz->y, yz->x
RECT_UAXIS = (0, 0, 1)   # xy->x, xz->x, yz->y
RECT_VAXIS = (1, 2, 2)   # xy->y, xz->z, yz->z


class Hit(NamedTuple):
    t: torch.Tensor        # (N,) BIG when miss
    hit: torch.Tensor      # (N,) bool
    p: torch.Tensor        # (N, 3)
    normal: torch.Tensor   # (N, 3) stored normal (may be flipped)
    uv: torch.Tensor       # (N, 2)
    mat: torch.Tensor      # (N,) int64 material id (0 when miss)

    @staticmethod
    def none(n: int, device) -> "Hit":
        z = torch.zeros((n, 3), dtype=torch.float32, device=device)
        return Hit(t=torch.full((n,), BIG, device=device),
                   hit=torch.zeros((n,), dtype=torch.bool, device=device),
                   p=z, normal=z, uv=z[:, :2],
                   mat=torch.zeros((n,), dtype=torch.int64, device=device))

    def closer_of(self, other: "Hit") -> "Hit":
        take = other.hit & (other.t < self.t)
        t3 = take[:, None]
        return Hit(t=torch.where(take, other.t, self.t),
                   hit=self.hit | other.hit,
                   p=torch.where(t3, other.p, self.p),
                   normal=torch.where(t3, other.normal, self.normal),
                   uv=torch.where(t3, other.uv, self.uv),
                   mat=torch.where(take, other.mat, self.mat))


def sphere_uv(unit: torch.Tensor) -> torch.Tensor:
    """Spherical uv (``hitable.h:10-15``) with constant-angle poles."""
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    off_axis = x * x + z * z > 1e-12
    phi = torch.atan2(torch.where(off_axis, z, 0.0),
                      torch.where(off_axis, x, 1.0))
    y = torch.clamp(y, -1.0, 1.0)
    inner = torch.abs(y) < 0.999999
    theta = torch.where(inner, torch.asin(torch.where(inner, y, 0.0)),
                        torch.sign(y) * (0.5 * math.pi))
    u = 1.0 - (phi + math.pi) / (2.0 * math.pi)
    v = (theta + math.pi / 2.0) / math.pi
    return torch.stack([u, v], -1)


def _ray_at(o, d, t):
    return o + torch.clamp(t, max=T_POS_MAX)[:, None] * d


def _lerp_factor(times: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """``(time - t0) / (t1 - t0)`` as the kernels take it, times the
    table's reciprocal ``1 / max(t1 - t0, 1e-20)``; ``times`` (..., 2)
    broadcasts against ``time``."""
    inv_dt = 1.0 / torch.clamp(times[..., 1] - times[..., 0], min=1e-20)
    return (time - times[..., 0]) * inv_dt


def _near_root(oc, dd, r2, t_min):
    """The sphere test's quadratic for unit directions (the kernels'
    ``sphere_t``): ``(t, t1)``, ``t`` the nearer root beyond ``t_min``
    (BIG on a miss) and ``t1`` the far root; ``oc`` (..., 3) from the
    centre to the origin, ``dd`` the direction, ``r2`` the squared
    radius."""
    b = (oc[..., 0] * dd[..., 0] + oc[..., 1] * dd[..., 1]
         + oc[..., 2] * dd[..., 2])
    c = (oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1]
         + oc[..., 2] * oc[..., 2]) - r2
    disc = b * b - c                                     # unit d => a = 1
    sq = safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    valid0 = (disc > 0.0) & (t0 > t_min) & (t0 < BIG)
    valid1 = (disc > 0.0) & (t1 > t_min) & (t1 < BIG)
    return torch.where(valid0, t0, torch.where(valid1, t1, BIG)), t1


def _sphere_t(scene: TorchScene, o, d, time, t_min, c0, c1):
    """Each ray's distance to spheres ``c0:c1`` (N, C), BIG on a miss (the
    kernels' ``sphere_t``), and the spheres' centres at the rays' times
    (N, C, 3)."""
    cen0 = scene.sph_center0[c0:c1]                      # (C, 3)
    f = _lerp_factor(scene.sph_times[c0:c1][None], time[:, None])  # (N, C)
    cen = cen0[None] + f[..., None] * (scene.sph_center1[c0:c1] - cen0)[None]
    rad = scene.sph_radius[c0:c1]                        # (C,)
    t, t1 = _near_root(o[:, None, :] - cen, d[:, None, :],
                       rad[None] * rad[None], t_min)
    # env dome: always hit at the far crossing (env_sphere.h:27-38)
    env = scene.sph_env[c0:c1][None]
    return torch.where(env, torch.where(t1 > t_min, t1, BIG), t), cen


def _sphere_chunk(scene: TorchScene, o, d, time, t_min, c0, c1) -> Hit:
    t, cen = _sphere_t(scene, o, d, time, t_min, c0, c1)
    rad = scene.sph_radius[c0:c1]
    tb, k = torch.min(t, dim=1)                          # first on ties
    hit = tb < BIG
    p = _ray_at(o, d, tb)
    unit = (p - cen[torch.arange(o.shape[0], device=o.device), k]) \
        / rad[k][:, None]
    flip = scene.sph_flip[c0:c1][k] ^ scene.sph_env[c0:c1][k]
    normal = torch.where(flip[:, None], -unit, unit)
    return Hit(t=torch.where(hit, tb, BIG), hit=hit, p=p, normal=normal,
               uv=sphere_uv(unit), mat=scene.sph_mat[c0:c1][k].long())


def sphere_winner(scene: TorchScene, o: torch.Tensor, d: torch.Tensor,
                  time: torch.Tensor, t_min: float = 1e-3):
    """Each ray's closest sphere, the plain version of kernel B6
    (``srt_tpu/pallas/spheres.py:123-177``): ``(t, idx)``, ``t`` float32
    (BIG on a miss) and ``idx`` int32 (-1 on a miss); ``t < BIG`` to count,
    env domes at their far crossing, the first minimum on ties."""
    n, dev = o.shape[0], o.device
    t_best = torch.full((n,), BIG, device=dev)
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, scene.n_spheres, PRIM_CHUNK):
        c1 = min(c0 + PRIM_CHUNK, scene.n_spheres)
        tb, k = torch.min(_sphere_t(scene, o, d, time, t_min, c0, c1)[0], 1)
        better = tb < t_best
        t_best = torch.where(better, tb, t_best)
        idx = torch.where(better, (k + c0).to(torch.int32), idx)
    return t_best, idx


def assemble_sphere_hit(scene: TorchScene, o: torch.Tensor, d: torch.Tensor,
                        time: torch.Tensor, t_min: float,
                        k: torch.Tensor) -> Hit:
    """The differentiable hit on each ray's winning sphere ``k`` (-1: a
    miss), the port of ``_assemble_sphere_hit`` (``intersect.py:91-129``):
    the near root when it lies beyond ``t_min``, else the far root, which
    an env dome always takes. The winner is detached; the hit's ``t``,
    position, normal and uv follow the sphere's centre and radius.
    ``safe_sqrt`` and the position clamp at ``T_POS_MAX`` keep miss lanes
    free of NaN in the backward."""
    hit_any = k >= 0
    kc = torch.clamp(k, min=0).long()
    cen0 = scene.sph_center0[kc]
    f = _lerp_factor(scene.sph_times[kc], time)
    cen = cen0 + f[:, None] * (scene.sph_center1[kc] - cen0)
    rad = scene.sph_radius[kc]
    oc = o - cen
    b = dot(oc, d)
    c = dot(oc, oc) - rad * rad
    disc = b * b - c
    sq = safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    env = scene.sph_env[kc]
    t = torch.where(env | ~((disc > 0.0) & (t0 > t_min)), t1, t0)
    hit = hit_any & (t > t_min)
    tb = torch.where(hit, t, BIG)
    p = _ray_at(o, d, tb)
    unit = (p - cen) / rad[:, None]
    flip = scene.sph_flip[kc] ^ env
    normal = torch.where(flip[:, None], -unit, unit)
    return Hit(t=tb, hit=hit, p=p, normal=normal, uv=sphere_uv(unit),
               mat=scene.sph_mat[kc].long())


def _rect_chunk(scene: TorchScene, o, d, t_min, c0, c1) -> Hit:
    axis = scene.rect_axis[c0:c1].long()                 # (C,)
    bounds = scene.rect_bounds[c0:c1]                    # (C, 4)
    kplane = scene.rect_k[c0:c1]
    dev = o.device
    na = torch.tensor(RECT_NAXIS, device=dev)[axis]
    ua = torch.tensor(RECT_UAXIS, device=dev)[axis]
    va = torch.tensor(RECT_VAXIS, device=dev)[axis]
    o_n, d_n = o[:, na], d[:, na]                        # (N, C)
    t = gsdiv(kplane[None] - o_n,
              torch.where(torch.abs(d_n) < 1e-20, 1e-20, d_n))
    pu = o[:, ua] + t * d[:, ua]
    pv = o[:, va] + t * d[:, va]
    inside = ((pu >= bounds[None, :, 0]) & (pu <= bounds[None, :, 1])
              & (pv >= bounds[None, :, 2]) & (pv <= bounds[None, :, 3]))
    valid = inside & (t > t_min) & (t < BIG)
    t = torch.where(valid, t, BIG)

    tb, k = torch.min(t, dim=1)
    hit = tb < BIG
    b = bounds[k]
    kk = k[:, None]
    u = (torch.gather(pu, 1, kk)[:, 0] - b[:, 0]) / (b[:, 1] - b[:, 0])
    v = (torch.gather(pv, 1, kk)[:, 0] - b[:, 2]) / (b[:, 3] - b[:, 2])
    normal = torch.nn.functional.one_hot(na[k], 3).to(torch.float32)
    normal = torch.where(scene.rect_flip[c0:c1][k][:, None], -normal, normal)
    return Hit(t=torch.where(hit, tb, BIG), hit=hit, p=_ray_at(o, d, tb),
               normal=normal, uv=torch.stack([u, v], -1),
               mat=scene.rect_mat[c0:c1][k].long())


def _tri_intersect(p0, p1, p2, o, d, t_min, t_max):
    """Möller–Trumbore of ray ``i`` against triangle ``i`` (math and guards
    of ``intersect.py:347-369``): returns ``(t, u, v, valid)``."""
    e1 = p1 - p0
    e2 = p2 - p0
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


def _slab(lo, hi, o, inv_d, t_min, t_best):
    """Each ray's box test against its own node (lo, hi), pruned by its
    best ``t``."""
    tt0 = (lo - o) * inv_d
    tt1 = (hi - o) * inv_d
    tn = torch.minimum(tt0, tt1).amax(-1)
    tf = torch.maximum(tt0, tt1).amin(-1)
    return (tf >= torch.clamp(tn, min=t_min)) & (tn < t_best)


def intersect_tris(scene: TorchScene, o: torch.Tensor, d: torch.Tensor,
                   t_min: float = 1e-3, leaf_size: int = 4,
                   stats: bool = False):
    """Closest triangle per ray over the skip-link BVH: ``(t, u, v, tri)``
    with ``t = BIG``, ``u = v = 0`` and ``tri = 0`` on a miss. A box test
    descends to node ``i+1`` on an inner node it hits and jumps to
    ``skip[i]`` otherwise; ``t_best`` prunes the box test; a strict ``<``
    keeps the first triangle in walk order. ``leaf_size`` is the widest
    leaf (``SceneFlags.bvh_leaf``; the builder's default is 4). With
    ``stats`` it also returns each ray's node visits and triangle tests
    (int64)."""
    n, dev = o.shape[0], o.device
    t_best = torch.full((n,), BIG, device=dev)
    u_best = torch.zeros((n,), device=dev)
    v_best = torch.zeros((n,), device=dev)
    i_best = torch.zeros((n,), dtype=torch.int64, device=dev)
    visits = torch.zeros((n,), dtype=torch.int64, device=dev)
    tests = torch.zeros((n,), dtype=torch.int64, device=dev)
    n_nodes, n_tris = scene.n_bvh_nodes, scene.n_tris
    inv_d = _safe_inv(d)
    cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
    while n_nodes:
        active = cursor < n_nodes
        if not bool(active.any()):
            break
        cur = torch.clamp(cursor, max=n_nodes - 1)
        box_hit = _slab(scene.bvh_lo[cur], scene.bvh_hi[cur], o, inv_d,
                        t_min, t_best)
        first = scene.bvh_first[cur].long()
        count = scene.bvh_count[cur].long()
        is_leaf = first >= 0
        for j in range(leaf_size):
            tri = torch.clamp(first + j, 0, n_tris - 1)
            lane = active & is_leaf & box_hit & (j < count)
            t, u, v, valid = _tri_intersect(
                scene.tri_p0[tri], scene.tri_p1[tri], scene.tri_p2[tri], o,
                d, t_min, t_best)
            better = lane & valid & (t < t_best)
            t_best = torch.where(better, t, t_best)
            u_best = torch.where(better, u, u_best)
            v_best = torch.where(better, v, v_best)
            i_best = torch.where(better, tri, i_best)
            tests += lane
        visits += active
        descend = active & box_hit & ~is_leaf
        cursor = torch.where(active, torch.where(
            descend, cursor + 1, scene.bvh_skip[cur].long()), cursor)
    out = (t_best, u_best, v_best, i_best)
    return out + (visits, tests) if stats else out


def cluster_records(scene: TorchScene) -> dict:
    """The cluster blocks of the two-level BVH as one record per row:
    ``lo``, ``hi`` (Nc*node_cap, 3), ``skip``, ``first``, ``count``
    (Nc*node_cap,) with local ids, triangles ``p`` (Nc*tri_cap, 9) as p0,
    p1, p2; and the caps."""
    nc, _, rows_n, lanes = scene.cl_nodes_f.shape
    node_cap, tri_cap = rows_n * lanes, scene.cl_tris.shape[2] * lanes
    f = scene.cl_nodes_f.reshape(nc, 6, node_cap).transpose(1, 2)
    i = scene.cl_nodes_i.reshape(nc, 3, node_cap)
    p = scene.cl_tris.reshape(nc, 9, tri_cap).transpose(1, 2)
    return dict(lo=f[..., :3].reshape(-1, 3), hi=f[..., 3:].reshape(-1, 3),
                skip=i[:, 0].reshape(-1), first=i[:, 1].reshape(-1),
                count=i[:, 2].reshape(-1), p=p.reshape(-1, 9),
                node_cap=node_cap, tri_cap=tri_cap)


def intersect_tris_big(scene: TorchScene, o: torch.Tensor, d: torch.Tensor,
                       t_min: float = 1e-3, leaf_size: int = 4,
                       stats: bool = False):
    """Closest triangle per ray over the two-level BVH, the plain version
    of kernel B4 (``srt_tpu/pallas/intersect_big.py:_kernel``): ``(t, u,
    v, tri)`` as :func:`intersect_tris` gives them, ``tri`` the global
    index ``k + tri_base`` of the cluster's local triangle ``k``. Each ray
    walks the top tree by its skip links; at a cluster leaf its box test
    hits, it walks that cluster's local skip-link tree to its end (the
    padding node after the last real node ends it), then resumes at the
    leaf's skip. Every ray advances one node a round, in lockstep, until
    all are done. The same tree in the same order as the single-level
    walk: the two agree to the bit. With ``stats`` it also returns each
    ray's top-tree visits, cluster-node visits and triangle tests (int64)
    and ``seen``, the records any ray read: bool masks over the top tree
    (Bt,), the cluster nodes (Nc*node_cap,) and the cluster triangles
    (Nc*tri_cap,), the last two in :func:`cluster_records`' order."""
    n, dev = o.shape[0], o.device
    t_best = torch.full((n,), BIG, device=dev)
    u_best = torch.zeros((n,), device=dev)
    v_best = torch.zeros((n,), device=dev)
    i_best = torch.zeros((n,), dtype=torch.int64, device=dev)
    top_visits, cl_visits, tests = (
        torch.zeros((n,), dtype=torch.int64, device=dev) for _ in range(3))
    inv_d = _safe_inv(d)
    n_top = 0 if scene.top_skip is None else scene.top_skip.shape[0]
    top = torch.zeros((n,), dtype=torch.int64, device=dev)
    cl = torch.full((n,), -1, dtype=torch.int64, device=dev)
    local = torch.zeros((n,), dtype=torch.int64, device=dev)
    base = torch.zeros((n,), dtype=torch.int64, device=dev)
    rec = cluster_records(scene) if n_top else None
    n_nodes, n_cl_tris = ((rec["skip"].shape[0], rec["p"].shape[0])
                          if n_top else (0, 0))
    # one slot past each table takes the rays that read nothing there
    seen = [torch.zeros((k + 1,), dtype=torch.bool, device=dev)
            for k in (n_top, n_nodes, n_cl_tris)]
    while n_top:
        in_cl = cl >= 0
        in_top = ~in_cl & (top < n_top)
        if not bool((in_top | in_cl).any()):
            break
        # rays in the top tree: one node each
        tc = torch.clamp(top, max=n_top - 1)
        box_top = _slab(scene.top_lo[tc], scene.top_hi[tc], o, inv_d, t_min,
                        t_best)
        leaf_cl = scene.top_cluster[tc].long()
        enter = in_top & box_top & (leaf_cl >= 0)
        # rays inside a cluster: one node each
        c0 = torch.clamp(cl, min=0)
        g = c0 * rec["node_cap"] + torch.clamp(local, max=rec["node_cap"] - 1)
        box_cl = _slab(rec["lo"][g], rec["hi"][g], o, inv_d, t_min, t_best)
        first, count = rec["first"][g].long(), rec["count"][g].long()
        leaf = in_cl & box_cl & (first >= 0)
        for j in range(leaf_size):
            k = torch.clamp(first + j, 0, rec["tri_cap"] - 1)
            lane = leaf & (j < count)
            p = rec["p"][c0 * rec["tri_cap"] + k]
            t, u, v, valid = _tri_intersect(p[:, 0:3], p[:, 3:6], p[:, 6:9],
                                            o, d, t_min, t_best)
            better = lane & valid & (t < t_best)
            t_best = torch.where(better, t, t_best)
            u_best = torch.where(better, u, u_best)
            v_best = torch.where(better, v, v_best)
            i_best = torch.where(better, k + base, i_best)
            tests += lane
            if stats:
                seen[2][torch.where(lane, c0 * rec["tri_cap"] + k,
                                    n_cl_tris)] = True
        top_visits += in_top
        cl_visits += in_cl
        if stats:
            seen[0][torch.where(in_top, tc, n_top)] = True
            seen[1][torch.where(in_cl, g, n_nodes)] = True
        # advance: a cluster walk ends past its padded block
        local = torch.where(box_cl & (first < 0), local + 1,
                            rec["skip"][g].long())
        cl = torch.where(in_cl & (local >= rec["node_cap"]), -1, cl)
        top_next = torch.where(box_top & (leaf_cl < 0), top + 1,
                               scene.top_skip[tc].long())
        top = torch.where(in_top, top_next, top)
        cl = torch.where(enter, leaf_cl, cl)
        base = torch.where(enter, scene.top_tri_base[tc].long(), base)
        local = torch.where(enter, 0, local)
    out = (t_best, u_best, v_best, i_best)
    seen = tuple(m[:-1] for m in seen)
    return out + (top_visits, cl_visits, tests, seen) if stats else out


def two_level(scene: TorchScene) -> bool:
    """The JAX package's rule (``srt_tpu/pallas/intersect.py:50-60``): a
    mesh whose nodes and triangles take more than
    :data:`SINGLE_LEVEL_BUDGET` bytes at 36 bytes each takes the two-level
    walk, any other the single-level one."""
    return (scene.n_tris > 0 and (scene.n_bvh_nodes * 36 + scene.n_tris * 36
                                  > SINGLE_LEVEL_BUDGET))


def intersect_tris_any(scene: TorchScene, o: torch.Tensor, d: torch.Tensor,
                       t_min: float = 1e-3, leaf_size: int = 4):
    """The plain walk :func:`two_level` picks for ``scene``."""
    walk = intersect_tris_big if two_level(scene) else intersect_tris
    return walk(scene, o, d, t_min, leaf_size)


def tri_hit(scene: TorchScene, o: torch.Tensor, d: torch.Tensor, t, u, v,
            tri) -> Hit:
    """The hit record of a closest triangle ``(t, u, v, tri)``
    (``intersect.py:396-403``): barycentric uv, the normalised
    interpolated shading normal, the triangle's material."""
    hit = t < BIG
    w = (1.0 - u - v)[:, None]
    u, v, tri = u[:, None], v[:, None], tri.long()
    uvs, ns = scene.tri_uv[tri], scene.tri_n[tri]
    return Hit(t=torch.where(hit, t, BIG), hit=hit, p=_ray_at(o, d, t),
               normal=normalize(ns[:, 0] * w + ns[:, 1] * u + ns[:, 2] * v),
               uv=uvs[:, 0] * w + uvs[:, 1] * u + uvs[:, 2] * v,
               mat=scene.tri_mat[tri].long())


#: the sphere tensors the sphere BVH's boxes are built from: a tree walked
#: while one of them is optimised would hold the spheres' old boxes
SPHERE_GEOM_FIELDS = ("sph_center0", "sph_center1", "sph_times",
                      "sph_radius")


def require_fresh_tree(scene: TorchScene) -> None:
    """Raise ``ValueError`` when a sphere geometry tensor of ``scene``
    requires a gradient: optimising it would leave the sphere BVH's boxes
    where the spheres were when the scene was built. The JAX package walks
    such a stale tree silently; the port refuses it."""
    live = [k for k in SPHERE_GEOM_FIELDS
            if getattr(scene, k).requires_grad]
    if live:
        raise ValueError(
            f"the sphere BVH is built from the spheres' starting geometry; "
            f"{live} require a gradient, so the tree would go stale. Turn "
            f"the sphere BVH off (RenderConfig.sphere_bvh, "
            f"make_train_step(sphere_bvh=False)) to optimise sphere "
            f"geometry")


def sphere_bvh_winner(scene: TorchScene, o: torch.Tensor, d: torch.Tensor,
                      time: torch.Tensor, t_min: float = 1e-3,
                      leaf_size: int = 4, stats: bool = False):
    """Each ray's closest sphere that is not an environment dome, over the
    sphere BVH (``sbvh_*``), the winner search of JAX's
    ``intersect_spheres_bvh`` (``srt_tpu/render/intersect.py:143-220``):
    ``idx`` int32, -1 on a miss. The walk is the plain triangle walk's
    (:func:`intersect_tris`): a box test descends to node ``i+1`` on an
    inner node it hits and jumps to ``skip[i]`` otherwise, ``t_best``
    prunes it, and a leaf tests up to ``leaf_size`` spheres
    (``SceneFlags.sbvh_leaf``) gathered through ``sbvh_ids``, a strict
    ``<`` keeping the first in walk order. Each sphere test is the
    sweep's (:func:`_sphere_t`, the same float operations) on a record
    packed once a call: centre, the centre's motion, shutter start, the
    reciprocal of its span, squared radius. The host reads the count of
    rays still walking once a round; when a quarter of the working set has
    left the tree, those rays' winners are written out and the rest
    compacted, so a round costs the rays still walking. Ties: spheres at
    exactly equal ``t`` may give another winner than the sweep's lowest
    index, as in JAX. No autograd. With ``stats`` it also returns each
    ray's node visits (int64)."""
    n, dev = o.shape[0], o.device
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros((n,), dtype=torch.int64, device=dev)
    n_nodes, n_ids = scene.sbvh_skip.shape[0], scene.sbvh_ids.shape[0]
    slots = torch.arange(leaf_size, device=dev)
    with torch.no_grad():
        times = scene.sph_times
        rec = torch.cat([
            scene.sph_center0, scene.sph_center1 - scene.sph_center0,
            times[:, :1],
            1.0 / torch.clamp(times[:, 1:] - times[:, :1], min=1e-20),
            (scene.sph_radius * scene.sph_radius)[:, None]], 1)
        box = torch.cat([scene.sbvh_lo, scene.sbvh_hi], 1)
        link = torch.stack([scene.sbvh_first, scene.sbvh_count,
                            scene.sbvh_skip], 1).long()
        lane = torch.arange(n, device=dev)
        o, d, time = o.detach(), d.detach(), time.detach()
        inv_d = _safe_inv(d)
        cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
        t_best = torch.full((n,), BIG, device=dev)
        k_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        vis = torch.zeros((n,), dtype=torch.int64, device=dev)
        live = n if n_nodes else 0
        while live:
            active = cursor < n_nodes
            cur = torch.clamp(cursor, max=n_nodes - 1)
            nb, nl = box[cur], link[cur]
            box_hit = _slab(nb[:, :3], nb[:, 3:], o, inv_d, t_min, t_best)
            is_leaf = nl[:, 0] >= 0
            test = ((active & box_hit & is_leaf)[:, None]
                    & (slots < nl[:, 1:2]))
            sid = scene.sbvh_ids[torch.clamp(nl[:, :1] + slots, 0,
                                             n_ids - 1)].long()
            r = rec[sid]                                  # (L, leaf, 9)
            f = (time[:, None] - r[..., 6]) * r[..., 7]
            cen = r[..., :3] + f[..., None] * r[..., 3:6]
            t, _ = _near_root(o[:, None, :] - cen, d[:, None, :], r[..., 8],
                              t_min)
            tb, j = torch.min(torch.where(test, t, BIG), 1)
            better = tb < t_best
            t_best = torch.where(better, tb, t_best)
            k_best = torch.where(better, sid.gather(1, j[:, None])[:, 0],
                                 k_best)
            vis += active
            cursor = torch.where(active, torch.where(
                box_hit & ~is_leaf, cursor + 1, nl[:, 2]), cursor)
            live = int((cursor < n_nodes).sum())     # one read a round
            if live <= 3 * lane.numel() // 4:
                # a quarter done: results out, the rest compacted
                idx[lane] = k_best.to(torch.int32)
                visits[lane] = vis
                keep = torch.nonzero(cursor < n_nodes)[:, 0]
                lane, o, d, time, inv_d, cursor, t_best, k_best, vis = (
                    x[keep] for x in (lane, o, d, time, inv_d, cursor,
                                      t_best, k_best, vis))
        idx[lane] = k_best.to(torch.int32)
        visits[lane] = vis
    return (idx, visits) if stats else idx


def intersect_spheres_bvh(scene: TorchScene, o: torch.Tensor,
                          d: torch.Tensor, time: torch.Tensor,
                          t_min: float = 1e-3, leaf_size: int = 4) -> Hit:
    """Closest sphere hit through the sphere BVH, the port of JAX's
    ``intersect_spheres_bvh`` (``intersect.py:143-230``): the winner from
    :func:`sphere_bvh_winner`, detached, its hit re-assembled
    differentiably (:func:`assemble_sphere_hit`), then each environment
    dome (``sph_env_ids``, which the tree leaves out) by brute force, a
    dome winning only when strictly nearer. The tree must have been built
    from the scene's current geometry (:func:`require_fresh_tree`)."""
    n = o.shape[0]
    k = sphere_bvh_winner(scene, o, d, time, t_min, leaf_size)
    best = assemble_sphere_hit(scene, o, d, time, t_min, k)
    for e in scene.sph_env_ids.tolist():
        k_env = torch.full((n,), e, dtype=torch.int32, device=o.device)
        best = best.closer_of(assemble_sphere_hit(scene, o, d, time, t_min,
                                                  k_env))
    return best


def intersect_scene(scene: TorchScene, o: torch.Tensor, d: torch.Tensor,
                    t_min: float = 1e-3, tri=None, leaf_size: int = 4,
                    time: torch.Tensor | None = None, sph=None,
                    sphere_bvh: bool = False, sbvh_leaf: int = 4) -> Hit:
    """Closest hit over every sphere, then every rect, then the triangles
    (an earlier family wins ties), at the rays' ``time`` (0 when None).
    ``sph`` is the spheres' winner ``(t, idx)`` when the caller has it
    (kernel B6's output): the sphere hit is then assembled from it
    (:func:`assemble_sphere_hit`) instead of swept. Otherwise, with
    ``sphere_bvh`` on a scene that has a sphere BVH, the spheres are
    walked through it (:func:`intersect_spheres_bvh`, leaves of up to
    ``sbvh_leaf``; a scene whose sphere geometry requires a gradient
    raises, :func:`require_fresh_tree`), as JAX's ``intersect_scene`` does
    under ``SRT_TPU_SPHERE_BVH=on`` (``intersect.py:519-535``); else
    swept. ``tri`` is the triangles' closest hit ``(t, u, v, tri)`` when
    the caller has it (kernel B3's or B4's output); otherwise
    :func:`intersect_tris_any` computes it with ``leaf_size``."""
    best = Hit.none(o.shape[0], o.device)
    if time is None:
        time = torch.zeros(o.shape[0], device=o.device)
    sweep = scene.n_spheres if sph is None else 0
    if scene.n_spheres and sph is not None:
        best = assemble_sphere_hit(scene, o, d, time, t_min, sph[1])
    elif sweep and sphere_bvh and scene.sbvh_ids is not None:
        require_fresh_tree(scene)
        best = intersect_spheres_bvh(scene, o, d, time, t_min, sbvh_leaf)
        sweep = 0
    for c0 in range(0, sweep, PRIM_CHUNK):
        c1 = min(c0 + PRIM_CHUNK, scene.n_spheres)
        best = best.closer_of(_sphere_chunk(scene, o, d, time, t_min, c0,
                                            c1))
    for c0 in range(0, scene.n_rects, PRIM_CHUNK):
        c1 = min(c0 + PRIM_CHUNK, scene.n_rects)
        best = best.closer_of(_rect_chunk(scene, o, d, t_min, c0, c1))
    if scene.n_tris:
        if tri is None:
            tri = intersect_tris_any(scene, o, d, t_min, leaf_size)
        best = best.closer_of(tri_hit(scene, o, d, *tri))
    return best
