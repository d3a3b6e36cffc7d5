"""Next-event light sampling over rect and sphere lights (counterpart of
``srt_tpu/render/lights.py``; the reference's ``hitable_pdf`` with
``xz_rect::random``/``pdf_value``, ``aarect.h:45-60``, and
``sphere::random``/``pdf_value``, ``sphere.h:69-86``)."""
from __future__ import annotations

import math

import torch

from srt_tpu_torch.core.gradsafe import gsdiv
from srt_tpu_torch.core.vecmath import (dot, normalize, onb_from_w,
                                        safe_sqrt, to_world)
from srt_tpu_torch.render.intersect import RECT_NAXIS, RECT_UAXIS, RECT_VAXIS
from srt_tpu_torch.scene.ir import LightKind, TorchScene


def _rect(scene: TorchScene, ridx: int):
    """Host-side record of rect ``ridx``: axes, plane, bounds."""
    axis = int(scene.rect_axis[ridx])
    return (RECT_NAXIS[axis], RECT_UAXIS[axis], RECT_VAXIS[axis],
            scene.rect_k[ridx], scene.rect_bounds[ridx])


def _lights(scene: TorchScene):
    """``(kind, index)`` of each light, read on the host."""
    return list(zip(scene.light_kind.tolist(), scene.light_index.tolist()))


def _rect_sample(scene: TorchScene, ridx: int, p, u1, u2):
    """A unit direction toward a uniform point on the rect."""
    na, ua, va, k, b = _rect(scene, ridx)
    point = torch.empty_like(p)
    point[:, na] = k
    point[:, ua] = b[0] + u1 * (b[1] - b[0])
    point[:, va] = b[2] + u2 * (b[3] - b[2])
    return normalize(point - p)


def _rect_pdf(scene: TorchScene, ridx: int, p, wi):
    """Solid-angle pdf of the rect seen from ``p`` (``aarect.h:45-55``)."""
    na, ua, va, k, b = _rect(scene, ridx)
    d_n = wi[:, na]
    t = gsdiv(k - p[:, na], torch.where(torch.abs(d_n) < 1e-12, 1e-12, d_n))
    hu = p[:, ua] + t * wi[:, ua]
    hv = p[:, va] + t * wi[:, va]
    inside = ((t > 1e-3) & (hu >= b[0]) & (hu <= b[1])
              & (hv >= b[2]) & (hv <= b[3]))
    area = (b[1] - b[0]) * (b[3] - b[2])
    pdf = gsdiv(t * t, torch.clamp(torch.abs(d_n) * area, min=1e-12))
    return torch.where(inside, pdf, 0.0)


def _sphere_sample(scene: TorchScene, sidx: int, p, u1, u2):
    """Cone sampling toward the sphere (``sphere.h:7-15,80-86``). From
    inside the sphere (an emissive dome registered as a light) the cone
    degenerates, and the lane samples the whole sphere of directions
    uniformly, pdf 1/4π (:func:`_sphere_pdf`'s inside branch)."""
    center = scene.sph_center0[sidx]
    radius = scene.sph_radius[sidx]
    to_c = center - p
    dist_sq = dot(to_c, to_c)
    inside = dist_sq <= radius * radius
    cos_max = safe_sqrt(1.0 - radius * radius
                        / torch.clamp(dist_sq, min=1e-12))
    z = torch.where(inside, 1.0 - 2.0 * u2, 1.0 + u2 * (cos_max - 1.0))
    phi = 2.0 * math.pi * u1
    sq = safe_sqrt(1.0 - z * z)
    local = torch.stack([torch.cos(phi) * sq, torch.sin(phi) * sq, z], -1)
    return to_world(onb_from_w(to_c), local)


def _sphere_pdf(scene: TorchScene, sidx: int, p, wi):
    """1/solid angle where ``wi`` hits the sphere (``sphere.h:69-78``);
    1/4π from inside it."""
    center = scene.sph_center0[sidx]
    radius = scene.sph_radius[sidx]
    oc = p - center
    b = dot(oc, wi)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    sqd = safe_sqrt(disc)
    hits = (disc > 0.0) & ((-b - sqd > 1e-3) | (-b + sqd > 1e-3))
    cos_max = safe_sqrt(1.0 - radius * radius
                        / torch.clamp(c + radius * radius, min=1e-12))
    solid = 2.0 * math.pi * (1.0 - cos_max)
    pdf = torch.where(hits, 1.0 / torch.clamp(solid, min=1e-12), 0.0)
    return torch.where(c <= 0.0, 1.0 / (4.0 * math.pi), pdf)


def sample_lights(scene: TorchScene, p, u_pick, u1, u2):
    """Uniformly pick a light, sample a unit direction toward it
    (``hitable_list::random``, ``hitable_list.h:64-67``)."""
    n_lights = scene.n_lights
    pick = torch.clamp((u_pick * n_lights).to(torch.int32), max=n_lights - 1)
    wi = torch.zeros_like(p)
    for li, (kind, idx) in enumerate(_lights(scene)):
        sample = (_rect_sample if kind == int(LightKind.RECT)
                  else _sphere_sample)
        wi = torch.where((pick == li)[:, None], sample(scene, idx, p, u1, u2),
                         wi)
    return wi


def lights_pdf(scene: TorchScene, p, wi):
    """Uniform-mixture solid-angle pdf over all lights
    (``hitable_list::pdf_value``, ``hitable_list.h:54-62``)."""
    acc = torch.zeros_like(p[:, 0])
    for kind, idx in _lights(scene):
        pdf = _rect_pdf if kind == int(LightKind.RECT) else _sphere_pdf
        acc = acc + pdf(scene, idx, p, wi)
    return acc / scene.n_lights
