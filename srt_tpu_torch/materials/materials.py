"""Material shading: emission, BSDF sample/pdf/weight (counterpart of
``srt_tpu/materials/materials.py``) for the slice's families: Oren–Nayar,
anisotropic Beckmann and one-sided diffuse lights. Lambertian is the
default cosine lobe every other family falls back to.

Conventions as in the JAX package: the shading frame is built about the
face normal (the stored normal flipped toward the viewer), ``wo`` is the
local direction back along the incoming ray, and the integrator
multiplies throughput by ``bsdf_weight(wi) / pdf_mix(wi)`` with
``bsdf_weight`` = f·cosθi.
"""
from __future__ import annotations

import math

import torch

from srt_tpu_torch.core import frame
from srt_tpu_torch.core.gradsafe import gsdiv
from srt_tpu_torch.core.vecmath import (dot, normalize, onb_from_w,
                                        safe_normalize, to_local, to_world,
                                        where3)
from srt_tpu_torch.materials.microfacet import (beckmann_d, g,
                                                pdf_wh_visible,
                                                sample_wh_visible)
from srt_tpu_torch.materials.textures import texture_value
from srt_tpu_torch.scene.ir import MaterialType, SceneFlags, TorchScene

_INV_PI = 1.0 / math.pi
_BECK = int(MaterialType.BECKMANN)


def _alphas(scene: TorchScene, mat):
    """Beckmann alphas, floored: other materials' lanes read zeros."""
    params = scene.mat_params[mat]
    return (torch.where(params[:, 0] > 1e-4, params[:, 0], 1e-4),
            torch.where(params[:, 1] > 1e-4, params[:, 1], 1e-4))


def emitted(scene: TorchScene, mat, uv, normal, ray_dir, flags: SceneFlags):
    """One-sided emission (``material.h:348-354``): only where the stored
    normal faces the incoming ray."""
    is_light = scene.mat_type[mat] == int(MaterialType.DIFFUSE_LIGHT)
    facing = dot(normal, ray_dir) < 0.0
    e = texture_value(scene, scene.mat_tex[mat], uv, flags)
    return torch.where((is_light & facing)[:, None], e, 0.0)


def is_scattering(scene: TorchScene, mat):
    """False only for pure emitters (``material.h:344``)."""
    return scene.mat_type[mat] != int(MaterialType.DIFFUSE_LIGHT)


def face_basis(normal, ray_dir):
    """ONB about the normal oriented toward the viewer."""
    return onb_from_w(where3(dot(normal, ray_dir) > 0.0, -normal, normal))


def _oren_nayar_term(wi, wo, a, b):
    """cosI * (A + B*maxCos*sinAlpha*tanBeta) / pi (``pdf.h:64-101``)."""
    sin_ti, sin_to = frame.sin_theta(wi), frame.sin_theta(wo)
    d_cos = (frame.cos_phi(wi) * frame.cos_phi(wo)
             + frame.sin_phi(wi) * frame.sin_phi(wo))
    max_cos = torch.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                          torch.clamp(d_cos, min=0.0), 0.0)
    abs_ci, abs_co = torch.abs(wi[:, 2]), torch.abs(wo[:, 2])
    i_bigger = abs_ci > abs_co
    sin_alpha = torch.where(i_bigger, sin_to, sin_ti)
    tan_beta = torch.where(i_bigger,
                           gsdiv(sin_ti, torch.clamp(abs_ci, min=1e-8)),
                           gsdiv(sin_to, torch.clamp(abs_co, min=1e-8)))
    cos_i = torch.clamp(wi[:, 2], min=0.0)
    return cos_i * (a + b * max_cos * sin_alpha * tan_beta) * _INV_PI


def sample_bsdf(scene: TorchScene, mat, basis, wo, u1, u2,
                flags: SceneFlags):
    """World direction from the cosine lobe, or Beckmann's VNDF on
    Beckmann lanes (``pdf.h:30-59, 136-152``)."""
    phi = 2.0 * math.pi * u1
    sq = torch.sqrt(u2)
    cos_dir = torch.stack([torch.cos(phi) * sq, torch.sin(phi) * sq,
                           torch.sqrt(torch.clamp(1.0 - u2, min=0.0))], -1)
    cos_world = normalize(to_world(basis, cos_dir))
    if _BECK not in flags.mat_kinds:
        return cos_world
    ax, ay = _alphas(scene, mat)
    wh = sample_wh_visible(wo, ax, ay, u1, u2)
    beck_wi = -wo + 2.0 * dot(wo, wh)[:, None] * wh
    beck_world = normalize(to_world(basis, beck_wi))
    return where3(scene.mat_type[mat] == _BECK, beck_world, cos_world)


def bsdf_pdf(scene: TorchScene, mat, basis, wo, wi_world,
             flags: SceneFlags):
    """Density of :func:`sample_bsdf` at ``wi_world`` (for the mixture)."""
    wi = to_local(basis, wi_world)
    pdf = torch.clamp(wi[:, 2], min=0.0) * _INV_PI
    if _BECK not in flags.mat_kinds:
        return pdf
    wh = safe_normalize(wi + wo)
    ax, ay = _alphas(scene, mat)
    beck = gsdiv(pdf_wh_visible(wo, wh, ax, ay),
                 torch.clamp(4.0 * torch.abs(dot(wo, wh)), min=1e-8))
    beck = torch.where(frame.same_hemisphere(wo, wi), beck, 0.0)
    return torch.where(scene.mat_type[mat] == _BECK, beck, pdf)


def bsdf_weight(scene: TorchScene, mat, uv, basis, wo, wi_world,
                flags: SceneFlags):
    """f(wo, wi) * |cosθi| — the reference's attenuation*scattering_pdf."""
    t = scene.mat_type[mat]
    params = scene.mat_params[mat]
    alb = texture_value(scene, scene.mat_tex[mat], uv, flags)
    wi = to_local(basis, wi_world)
    w = torch.clamp(wi[:, 2], min=0.0) * _INV_PI         # Lambertian
    if int(MaterialType.OREN_NAYAR) in flags.mat_kinds:
        w_on = _oren_nayar_term(wi, wo, params[:, 0], params[:, 1])
        w = torch.where(t == int(MaterialType.OREN_NAYAR), w_on, w)
    if _BECK in flags.mat_kinds:
        wh = safe_normalize(wi + wo)
        ax, ay = _alphas(scene, mat)
        w_beck = gsdiv(beckmann_d(wh, ax, ay) * g(wo, wi, ax, ay),
                       torch.clamp(4.0 * torch.abs(wo[:, 2]), min=1e-8))
        w_beck = torch.where(frame.same_hemisphere(wo, wi), w_beck, 0.0)
        w = torch.where(t == _BECK, w_beck, w)
    return alb * w[:, None]
