"""Closest hits on the sphere and rect family: a dense sweep over chunks
of primitives, ties to the lowest index, spheres at their centre at the
ray's time, the environment dome always hit at its far crossing.

A frozen copy of the sphere and rect parts of
``srt_tpu_torch/render/intersect.py``. :func:`intersect_scene` sweeps the
three families in the port's order: spheres, rects, then the triangles of
:mod:`benchmark.reference.triangles`.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import triangles
from benchmark.reference.core import gsdiv, safe_sqrt
from benchmark.reference.hit import BIG, Hit, ray_at

PRIM_CHUNK = 128


# Per-rect-axis component indices (aarect.h:96-147): plane normal axis,
# and the two in-plane axes (u, v).
RECT_NAXIS = (2, 1, 0)   # xy->z, xz->y, yz->x
RECT_UAXIS = (0, 0, 1)   # xy->x, xz->x, yz->y
RECT_VAXIS = (1, 2, 2)   # xy->y, xz->z, yz->z


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


def _sphere_t(scene, o, d, time, t_min, c0, c1):
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


def _sphere_chunk(scene, o, d, time, t_min, c0, c1) -> Hit:
    t, cen = _sphere_t(scene, o, d, time, t_min, c0, c1)
    rad = scene.sph_radius[c0:c1]
    tb, k = torch.min(t, dim=1)                          # first on ties
    hit = tb < BIG
    p = ray_at(o, d, tb)
    unit = (p - cen[torch.arange(o.shape[0], device=o.device), k]) \
        / rad[k][:, None]
    flip = scene.sph_flip[c0:c1][k] ^ scene.sph_env[c0:c1][k]
    normal = torch.where(flip[:, None], -unit, unit)
    return Hit(t=torch.where(hit, tb, BIG), hit=hit, p=p, normal=normal,
               uv=sphere_uv(unit), mat=scene.sph_mat[c0:c1][k].long())


def _rect_chunk(scene, o, d, t_min, c0, c1) -> Hit:
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
    return Hit(t=torch.where(hit, tb, BIG), hit=hit, p=ray_at(o, d, tb),
               normal=normal, uv=torch.stack([u, v], -1),
               mat=scene.rect_mat[c0:c1][k].long())


def intersect_scene(scene, o: torch.Tensor, d: torch.Tensor,
                    t_min: float, time: torch.Tensor) -> Hit:
    """Closest hit over every sphere, then every rect, then every triangle
    (an earlier family wins ties), at the rays' ``time``: the sweep of
    ``srt_tpu_torch/render/intersect.py:intersect_scene``."""
    best = Hit.none(o.shape[0], o.device)
    for c0 in range(0, scene.n_spheres, PRIM_CHUNK):
        c1 = min(c0 + PRIM_CHUNK, scene.n_spheres)
        best = best.closer_of(_sphere_chunk(scene, o, d, time, t_min, c0,
                                            c1))
    for c0 in range(0, scene.n_rects, PRIM_CHUNK):
        c1 = min(c0 + PRIM_CHUNK, scene.n_rects)
        best = best.closer_of(_rect_chunk(scene, o, d, t_min, c0, c1))
    if scene.n_tris:
        best = best.closer_of(triangles.intersect(scene.soup, o, d, t_min,
                                                  best.t))
    return best
