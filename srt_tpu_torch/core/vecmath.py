"""Batched 3-vector math on ``(..., 3)`` tensors (counterpart of
``srt_tpu/core/vecmath.py``, ``core/onb.py`` and ``core/ray.py``).

Sums over the three components are written out in a fixed order, the
same order ``csrc/regen_bounce.cu`` uses, so the plain bounce and the
kernel round alike. A ray is the plain triple ``(origin, direction,
time)``; the orthonormal basis is the triple ``(u, v, w)``.
"""
from __future__ import annotations

import torch

from srt_tpu_torch.core.gradsafe import grad_safe_sqrt, gsrecip


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Unit vector: times the reciprocal of the clamped length (NaN-free
    gradient at the zero vector)."""
    inv = gsrecip(torch.clamp(grad_safe_sqrt(dot(a, a)), min=eps))
    return a * inv[..., None]


def safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit vector; degenerate input (|v|^2 <= eps) maps to +z."""
    l2 = dot(v, v)
    ok = l2 > eps
    up = torch.zeros_like(v)
    up[..., 2] = 1.0
    return (torch.where(ok[..., None], v, up)
            / torch.sqrt(torch.where(ok, l2, 1.0))[..., None])


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(x, 0))`` with +0 on clamped lanes."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def where3(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Select between ``(..., 3)`` tensors with a ``(...)`` mask."""
    return torch.where(mask[..., None], a, b)


def onb_from_w(n: torch.Tensor):
    """Orthonormal basis ``(u, v, w)`` about ``n`` (``onb.h:6-30``): the
    helper axis is +y where |w.x| > 0.9, else +x."""
    w = normalize(n)
    a = torch.zeros_like(w)
    big_x = torch.abs(w[..., 0]) > 0.9
    a[..., 0] = torch.where(big_x, 0.0, 1.0)
    a[..., 1] = torch.where(big_x, 1.0, 0.0)
    v = normalize(cross(w, a))
    return cross(w, v), v, w


def to_world(basis, a: torch.Tensor) -> torch.Tensor:
    u, v, w = basis
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w


def to_local(basis, a: torch.Tensor) -> torch.Tensor:
    u, v, w = basis
    return torch.stack([dot(a, u), dot(a, v), dot(a, w)], -1)
