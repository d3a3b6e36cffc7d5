"""Closest-hit intersection over spheres, rects and triangles
(counterpart of ``srt_tpu/render/intersect.py:39-565``).

Spheres and rects: a dense sweep over primitive chunks, the JAX package's
default for sphere scenes (its sphere BVH is opt-in and off the main
path). Ties keep the lowest index. Moving spheres are outside the port's
coverage, so centers are ``sph_center0``.

Triangles: :func:`intersect_tris` is the plain version of kernel B3, the
per-ray stackless skip-link walk over the scene's BVH with
Möller–Trumbore tests (``intersect.py:347-498``), every ray's cursor
advanced in lockstep until all have left the tree. A triangle wins only
when strictly nearer than the spheres' and rects' best hit.
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


def _sphere_chunk(scene: TorchScene, o, d, t_min, c0, c1) -> Hit:
    cen = scene.sph_center0[c0:c1]                       # (C, 3)
    rad = scene.sph_radius[c0:c1]                        # (C,)
    oc = o[:, None, :] - cen[None]                       # (N, C, 3)
    dd = d[:, None, :]
    b = (oc[..., 0] * dd[..., 0] + oc[..., 1] * dd[..., 1]
         + oc[..., 2] * dd[..., 2])
    c = (oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1]
         + oc[..., 2] * oc[..., 2]) - rad[None] * rad[None]
    disc = b * b - c                                     # unit d => a = 1
    sq = safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    valid0 = (disc > 0.0) & (t0 > t_min) & (t0 < BIG)
    valid1 = (disc > 0.0) & (t1 > t_min) & (t1 < BIG)
    t = torch.where(valid0, t0, torch.where(valid1, t1, BIG))
    # env dome: always hit at the far crossing (env_sphere.h:27-38)
    env = scene.sph_env[c0:c1][None]
    t = torch.where(env, torch.where(t1 > t_min, t1, BIG), t)

    tb, k = torch.min(t, dim=1)                          # first on ties
    hit = tb < BIG
    p = _ray_at(o, d, tb)
    unit = (p - cen[k]) / rad[k][:, None]
    flip = scene.sph_flip[c0:c1][k] ^ scene.sph_env[c0:c1][k]
    normal = torch.where(flip[:, None], -unit, unit)
    return Hit(t=torch.where(hit, tb, BIG), hit=hit, p=p, normal=normal,
               uv=sphere_uv(unit), mat=scene.sph_mat[c0:c1][k].long())


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
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
    while n_nodes:
        active = cursor < n_nodes
        if not bool(active.any()):
            break
        cur = torch.clamp(cursor, max=n_nodes - 1)
        tt0 = (scene.bvh_lo[cur] - o) * inv_d
        tt1 = (scene.bvh_hi[cur] - o) * inv_d
        tn = torch.minimum(tt0, tt1).amax(-1)
        tf = torch.maximum(tt0, tt1).amin(-1)
        box_hit = (tf >= torch.clamp(tn, min=t_min)) & (tn < t_best)
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


def intersect_scene(scene: TorchScene, o: torch.Tensor, d: torch.Tensor,
                    t_min: float = 1e-3, tri=None,
                    leaf_size: int = 4) -> Hit:
    """Closest hit over every sphere, then every rect, then the triangles
    (an earlier family wins ties). ``tri`` is the triangles' closest hit
    ``(t, u, v, tri)`` when the caller has it (kernel B3's output);
    otherwise :func:`intersect_tris` computes it with ``leaf_size``."""
    best = Hit.none(o.shape[0], o.device)
    for c0 in range(0, scene.n_spheres, PRIM_CHUNK):
        c1 = min(c0 + PRIM_CHUNK, scene.n_spheres)
        best = best.closer_of(_sphere_chunk(scene, o, d, t_min, c0, c1))
    for c0 in range(0, scene.n_rects, PRIM_CHUNK):
        c1 = min(c0 + PRIM_CHUNK, scene.n_rects)
        best = best.closer_of(_rect_chunk(scene, o, d, t_min, c0, c1))
    if scene.n_tris:
        if tri is None:
            tri = intersect_tris(scene, o, d, t_min, leaf_size)
        best = best.closer_of(tri_hit(scene, o, d, *tri))
    return best
