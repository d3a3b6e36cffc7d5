"""Homogeneous participating media bounded by a sphere (kind 0) or an
axis-aligned box (kind 1): a frozen copy of
``srt_tpu_torch/render/integrator.py:apply_media`` for those two kinds
(``constant_medium.h:19-50``). A medium bounded by a mesh (kind 2) is
refused by :class:`benchmark.reference.scene.Scene`.
"""
from __future__ import annotations

import torch

from benchmark.reference.core import dot, grad_safe_sqrt, gsdiv, uniform
from benchmark.reference.hit import Hit, ray_at

#: the sampler dimension of medium 0's free flight; medium ``m`` draws
#: dimension ``DIM_MEDIUM + m``
DIM_MEDIUM = 0
SPHERE, BOX, MESH = 0, 1, 2


def apply_media(scene, o, d, salt, hit: Hit) -> Hit:
    """The surface hit ``hit``, overridden by a nearer in-scatter event,
    medium by medium: exponential free flight from where the ray enters
    the medium (or its origin, inside it) to where it leaves it or meets
    the surface. An event is a hit on the medium's isotropic material with
    normal +x and uv 0. ``salt``: the bounce's salt."""
    g = torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    inv = gsdiv(1.0, g)
    n = o.shape[0]
    for m, kind in enumerate(scene.med_kinds):
        oc = o - scene.med_center[m]
        bq = dot(oc, d)
        rad = scene.med_radius[m]
        cq = dot(oc, oc) - rad * rad
        disc = bq * bq - cq
        sq = grad_safe_sqrt(disc)
        half = scene.med_half[m]
        tt0 = (-half - oc) * inv
        tt1 = (half - oc) * inv
        lo, hi = torch.minimum(tt0, tt1), torch.maximum(tt0, tt1)
        b_in = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        b_out = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        if kind == BOX:
            t_in, t_out, ok = b_in, b_out, b_out > b_in
        else:
            t_in, t_out, ok = -bq - sq, -bq + sq, disc > 0.0
        t_enter = torch.maximum(t_in, torch.zeros_like(t_in))
        t_exit = torch.minimum(t_out, hit.t)
        inside = ok & (t_exit > t_enter)
        u = torch.clamp(uniform(salt, DIM_MEDIUM + m), min=1e-12)
        free = -torch.log(u) / scene.med_density[m]
        t_sc = t_enter + free
        event = inside & (free < (t_exit - t_enter)) & (t_sc < hit.t)
        normal = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
        normal[:, 0] = 1.0
        hit = hit.closer_of(Hit(
            t=t_sc, hit=event, p=ray_at(o, d, t_sc), normal=normal,
            uv=torch.zeros((n, 2), dtype=o.dtype, device=o.device),
            mat=scene.med_mat[m].long().expand(n)))
    return hit
