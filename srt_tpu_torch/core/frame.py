"""Shading-frame trigonometry on local-frame ``(..., 3)`` vectors whose +z
is the shading normal (counterpart of ``srt_tpu/core/frame.py``,
reference ``reflection.h:8-53``)."""
from __future__ import annotations

import torch

from srt_tpu_torch.core.gradsafe import grad_safe_sqrt, gsdiv


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return grad_safe_sqrt(1.0 - cos2_theta(w))


def tan_theta(w):
    """Sign-preserving, finite-safe tan."""
    c = w[..., 2]
    safe = torch.where(torch.abs(c) < 1e-8, torch.sign(c) * 1e-8 + 1e-20, c)
    return sin_theta(w) / safe


def tan2_theta(w):
    return gsdiv(sin2_theta(w), torch.clamp(cos2_theta(w), min=1e-20))


def cos_phi(w):
    st = sin_theta(w)
    return torch.where(st == 0.0, 1.0, torch.clamp(
        gsdiv(w[..., 0], torch.clamp(st, min=1e-20)), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return torch.where(st == 0.0, 0.0, torch.clamp(
        gsdiv(w[..., 1], torch.clamp(st, min=1e-20)), -1.0, 1.0))


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0
