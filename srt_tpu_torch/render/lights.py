"""Next-event light sampling over rect lights (counterpart of
``srt_tpu/render/lights.py``; the reference's ``hitable_pdf`` with
``xz_rect::random``/``pdf_value``, ``aarect.h:45-60``). Sphere lights are
outside the slice (the coverage gate refuses them)."""
from __future__ import annotations

import torch

from srt_tpu_torch.core.gradsafe import gsdiv
from srt_tpu_torch.core.vecmath import normalize
from srt_tpu_torch.render.intersect import RECT_NAXIS, RECT_UAXIS, RECT_VAXIS
from srt_tpu_torch.scene.ir import TorchScene


def _rect(scene: TorchScene, li: int):
    """Host-side record of light ``li``'s rect: axes, plane, bounds."""
    ridx = int(scene.light_index[li])
    axis = int(scene.rect_axis[ridx])
    b = scene.rect_bounds[ridx]
    return (RECT_NAXIS[axis], RECT_UAXIS[axis], RECT_VAXIS[axis],
            scene.rect_k[ridx], b)


def sample_lights(scene: TorchScene, p, u_pick, u1, u2):
    """Uniformly pick a light, sample a unit direction toward a uniform
    point on it (``hitable_list::random``, ``hitable_list.h:64-67``)."""
    n_lights = scene.n_lights
    pick = torch.clamp((u_pick * n_lights).to(torch.int32), max=n_lights - 1)
    wi = torch.zeros_like(p)
    for li in range(n_lights):
        na, ua, va, k, b = _rect(scene, li)
        point = torch.empty_like(p)
        point[:, na] = k
        point[:, ua] = b[0] + u1 * (b[1] - b[0])
        point[:, va] = b[2] + u2 * (b[3] - b[2])
        wi = torch.where((pick == li)[:, None], normalize(point - p), wi)
    return wi


def lights_pdf(scene: TorchScene, p, wi):
    """Uniform-mixture solid-angle pdf over all lights
    (``hitable_list::pdf_value``, ``hitable_list.h:54-62``)."""
    acc = torch.zeros_like(p[:, 0])
    for li in range(scene.n_lights):
        na, ua, va, k, b = _rect(scene, li)
        d_n = wi[:, na]
        t = gsdiv(k - p[:, na],
                  torch.where(torch.abs(d_n) < 1e-12, 1e-12, d_n))
        hu = p[:, ua] + t * wi[:, ua]
        hv = p[:, va] + t * wi[:, va]
        inside = ((t > 1e-3) & (hu >= b[0]) & (hu <= b[1])
                  & (hv >= b[2]) & (hv <= b[3]))
        area = (b[1] - b[0]) * (b[3] - b[2])
        pdf = gsdiv(t * t, torch.clamp(torch.abs(d_n) * area, min=1e-12))
        acc = acc + torch.where(inside, pdf, 0.0)
    return acc / scene.n_lights
