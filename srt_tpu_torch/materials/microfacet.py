"""Anisotropic Beckmann microfacet distribution with visible-normal
sampling (counterpart of ``srt_tpu/materials/microfacet.py``; reference
``microfacet_distribution.h``: D 155-162, Lambda 164-173, VNDF 12-107 and
175-211). Directions are in the local shading frame (+z = normal)."""
from __future__ import annotations

import math

import torch

from srt_tpu_torch.core import frame
from srt_tpu_torch.core.approx import (acos_as, erf_as, erf_reference_buggy,
                                      erfinv_giles)
from srt_tpu_torch.core.gradsafe import grad_safe_sqrt, gsdiv, gsrecip

_SQRT_PI_INV = 0.5641895835477563


def beckmann_d(wh, alphax, alphay):
    """Anisotropic Beckmann NDF; ``tan2`` clamped finite before the exp."""
    tan2 = torch.clamp(frame.tan2_theta(wh), max=1e8)
    cos2 = frame.cos2_theta(wh)
    cos4 = cos2 * cos2
    cp, sp = frame.cos_phi(wh), frame.sin_phi(wh)
    e = torch.exp(-tan2 * (cp * cp / (alphax * alphax)
                           + sp * sp / (alphay * alphay)))
    d = gsdiv(e, math.pi * alphax * alphay * torch.clamp(cos4, min=1e-16))
    return torch.where(tan2 < 1e8, d, 0.0)


def beckmann_lambda(w, alphax, alphay):
    """Rational-approx Lambda, evaluated on a clamped argument."""
    abs_tan = torch.clamp(torch.abs(frame.tan_theta(w)), max=1e8)
    cp, sp = frame.cos_phi(w), frame.sin_phi(w)
    alpha = torch.sqrt(cp * cp * alphax * alphax + sp * sp * alphay * alphay)
    a = gsrecip(torch.clamp(alpha * abs_tan, min=1e-16))
    a_safe = torch.clamp(a, 1e-4, 1.6)
    lam = ((1.0 - 1.259 * a_safe + 0.396 * a_safe * a_safe)
           / (3.535 * a_safe + 2.181 * a_safe * a_safe))
    return torch.where(a > 1.6, 0.0, lam)


def g1(w, alphax, alphay):
    return 1.0 / (1.0 + beckmann_lambda(w, alphax, alphay))


def g(wo, wi, alphax, alphay):
    return 1.0 / (1.0 + beckmann_lambda(wo, alphax, alphay)
                  + beckmann_lambda(wi, alphax, alphay))


def _beckmann_sample11(cos_theta_i, u1, u2, ref_parity: bool = False):
    """P22 slopes for the normal-incidence-stretched direction
    (``BeckmannSample11``, ``microfacet_distribution.h:34-107``): up to 9
    Newton-bisection steps in the erf domain; a lane freezes once
    |value| < 1e-5, as the reference breaks out. ``ref_parity`` bounds the
    bisection with the reference's broken Erf
    (:func:`erf_reference_buggy`), as its renders do."""
    r = torch.sqrt(-torch.log1p(-torch.clamp(u1, max=1.0 - 1e-7)))
    phi = 2.0 * math.pi * u2
    sx_normal = r * torch.cos(phi)
    sy_normal = r * torch.sin(phi)

    cos_t = torch.clamp(cos_theta_i, -1.0, 1.0)
    sin_t = grad_safe_sqrt(1.0 - cos_t * cos_t)
    tan_t = gsdiv(sin_t, torch.clamp(cos_t, min=1e-20))
    cot_t = gsrecip(torch.clamp(tan_t, min=1e-20))

    a = torch.full_like(u1, -1.0)
    c = (erf_reference_buggy if ref_parity else erf_as)(cos_t)
    sample_x = torch.clamp(u1, min=1e-6)
    theta_i = acos_as(torch.clamp(cos_t, -0.999999, 0.999999))
    fit = 1.0 + theta_i * (-0.876 + theta_i * (0.4265 - 0.0594 * theta_i))
    b = c - (1.0 + c) * torch.exp(
        fit * torch.log(torch.clamp(1.0 - sample_x, min=1e-30)))
    normalization = 1.0 / (1.0 + c + _SQRT_PI_INV * tan_t
                           * torch.exp(-cot_t * cot_t))

    done = torch.zeros_like(u1, dtype=torch.bool)
    for _ in range(9):                       # while (++it < 10)
        b = torch.where(done | ((b >= a) & (b <= c)), b, 0.5 * (a + c))
        inv_erf = erfinv_giles(b)
        value = (normalization
                 * (1.0 + b + _SQRT_PI_INV * tan_t
                    * torch.exp(-inv_erf * inv_erf))
                 - sample_x)
        derivative = normalization * (1.0 - inv_erf * tan_t)
        upd = ~done & (torch.abs(value) >= 1e-5)
        c = torch.where(upd & (value > 0.0), b, c)
        a = torch.where(upd & (value <= 0.0), b, a)
        step = gsdiv(value, torch.where(torch.abs(derivative) < 1e-20,
                                        torch.sign(derivative) * 1e-20
                                        + 1e-30, derivative))
        b = torch.where(upd, b - step, b)
        done = done | (torch.abs(value) < 1e-5)
    slope_x = erfinv_giles(b)
    slope_y = erfinv_giles(2.0 * torch.clamp(u2, min=1e-6) - 1.0)

    normal_inc = cos_theta_i > 0.9999
    return (torch.where(normal_inc, sx_normal, slope_x),
            torch.where(normal_inc, sy_normal, slope_y))


def sample_wh_visible(wo, alphax, alphay, u1, u2, ref_parity: bool = False):
    """Visible-normal Beckmann sampling: stretch, sample P22 slopes,
    rotate, unstretch, renormalize (``ref_parity``: see
    :func:`_beckmann_sample11`)."""
    flip = wo[..., 2] < 0.0
    wi = torch.where(flip[..., None], -wo, wo)
    st = torch.stack([alphax * wi[..., 0], alphay * wi[..., 1], wi[..., 2]],
                     -1)
    # divide, not multiply by the reciprocal: one ulp here flips the
    # cosThetaI > 0.9999 normal-incidence branch
    st = gsdiv(st, torch.clamp(torch.sqrt(
        st[..., 0] * st[..., 0] + st[..., 1] * st[..., 1]
        + st[..., 2] * st[..., 2]), min=1e-20)[..., None])
    sx, sy = _beckmann_sample11(st[..., 2], u1, u2, ref_parity)
    cp, sp = frame.cos_phi(st), frame.sin_phi(st)
    tmp = cp * sx - sp * sy
    sy = sp * sx + cp * sy
    sx = alphax * tmp
    sy = alphay * sy
    wh = torch.stack([-sx, -sy, torch.ones_like(sx)], -1)
    wh = gsdiv(wh, torch.clamp(torch.sqrt(
        wh[..., 0] * wh[..., 0] + wh[..., 1] * wh[..., 1]
        + wh[..., 2] * wh[..., 2]), min=1e-20)[..., None])
    return torch.where(flip[..., None], -wh, wh)


def pdf_wh_visible(wo, wh, alphax, alphay):
    """VNDF density D(wh) G1(wo) |wo.wh| / |cos(wo)|."""
    wo_wh = wo[..., 0] * wh[..., 0] + wo[..., 1] * wh[..., 1] \
        + wo[..., 2] * wh[..., 2]
    return gsdiv(beckmann_d(wh, alphax, alphay) * g1(wo, alphax, alphay)
                 * torch.abs(wo_wh),
                 torch.clamp(torch.abs(wo[..., 2]), min=1e-8))
