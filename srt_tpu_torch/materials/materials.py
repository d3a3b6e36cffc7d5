"""Material shading: emission, BSDF sample/pdf/weight (counterpart of
``srt_tpu/materials/materials.py``) for the slice's families: Oren–Nayar,
anisotropic Beckmann, MERL measured BRDFs and one-sided diffuse lights,
whose diffuse branch has Lambertian's cosine lobe as its default (MERL
samples it too), and the one-sample specular branch of metal, dielectric
and isotropic (:func:`scatter_specular`).
Albedo and emission are the material's texture at the hit's uv and
position (:func:`textures.texture_value`).

Conventions as in the JAX package: the shading frame is built about the
face normal (the stored normal flipped toward the viewer), ``wo`` is the
local direction back along the incoming ray, and the integrator
multiplies throughput by ``bsdf_weight(wi) / pdf_mix(wi)`` with
``bsdf_weight`` = f·cosθi.

Under ``SceneFlags.ref_parity`` the three BSDF functions take the
reference's as-implemented forms (``srt_tpu/materials/materials.py:
171-320``), which look like bugs and are reproduced, not fixed: Beckmann
in the frame of the raw stored normal (:func:`raw_frame`), sampled with
the broken Erf, its pdf ``D·G(d_world, wi)/(4|cosI||cosO|)`` with the
Lambda of the *world* ray direction, its weight ``D·G1(wo)/(4|cosO|)``
with no same-hemisphere clamp; Oren–Nayar with the plain cosine weight
and its full term in the pdf.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from srt_tpu_torch.core import frame
from srt_tpu_torch.core.approx import cbrt_pos
from srt_tpu_torch.core.gradsafe import grad_safe_sqrt, gsdiv
from srt_tpu_torch.core.vecmath import (dot, normalize, onb_from_w,
                                        safe_normalize, to_local, to_world,
                                        where3)
from srt_tpu_torch.materials import merl as merl_mod
from srt_tpu_torch.materials.microfacet import (beckmann_d,
                                                beckmann_lambda, g, g1,
                                                pdf_wh_visible,
                                                sample_wh_visible)
from srt_tpu_torch.materials.textures import texture_value
from srt_tpu_torch.scene.ir import (SPECULAR_MATS, MaterialType, SceneFlags,
                                    TorchScene)

_INV_PI = 1.0 / math.pi
_BECK = int(MaterialType.BECKMANN)
_METAL = int(MaterialType.METAL)
_DIEL = int(MaterialType.DIELECTRIC)
_ISO = int(MaterialType.ISOTROPIC)
_ON = int(MaterialType.OREN_NAYAR)
_MERL = int(MaterialType.MERL)


def _alphas(scene: TorchScene, mat):
    """Beckmann alphas, floored: other materials' lanes read zeros."""
    params = scene.mat_params[mat]
    return (torch.where(params[:, 0] > 1e-4, params[:, 0], 1e-4),
            torch.where(params[:, 1] > 1e-4, params[:, 1], 1e-4))


def emitted(scene: TorchScene, mat, uv, p, normal, ray_dir,
            flags: SceneFlags):
    """One-sided emission (``material.h:348-354``): only where the stored
    normal faces the incoming ray."""
    is_light = scene.mat_type[mat] == int(MaterialType.DIFFUSE_LIGHT)
    facing = dot(normal, ray_dir) < 0.0
    e = texture_value(scene, scene.mat_tex[mat], uv, p, flags)
    return torch.where((is_light & facing)[:, None], e, 0.0)


def is_scattering(scene: TorchScene, mat):
    """False only for pure emitters (``material.h:344``)."""
    return scene.mat_type[mat] != int(MaterialType.DIFFUSE_LIGHT)


def is_specular(scene: TorchScene, mat):
    """Materials of the one-sample specular branch
    (``Raytracing_n.cpp:66-70``): metal, dielectric, isotropic."""
    return torch.isin(scene.mat_type[mat],
                      torch.tensor(sorted(SPECULAR_MATS), device=mat.device))


def _safe_normalize_rcp(v):
    """Unit vector times the reciprocal length, +z for degenerate input:
    the JAX kernel's ``_safe_normalize3`` (``pallas/bounce.py:165-172``)."""
    l2 = dot(v, v)
    ok = l2 > 1e-12
    up = torch.zeros_like(v)
    up[:, 2] = 1.0
    inv = 1.0 / torch.sqrt(torch.where(ok, l2, 1.0))
    return torch.where(ok[:, None], v, up) * inv[:, None]


def _sphere_dir(u_z, u_phi):
    """(cos, sin) of the azimuth times the ring radius, and z, of a
    uniform direction (``_uniform_in_sphere`` without its radius)."""
    z = 1.0 - 2.0 * u_z
    phi = 2.0 * math.pi * u_phi
    r_xy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return r_xy, phi, z


def scatter_specular(scene: TorchScene, mat, uv, p, normal, ray_dir, u,
                     flags: SceneFlags):
    """The specular branch, in the forms of the JAX kernel
    (``srt_tpu/pallas/bounce.py:663-729``): returns the new direction and
    the attenuation (N, 3). ``normal`` is the stored normal, ``u`` the four
    uniforms of dimensions ``DIM_SPEC + i``. Metal: the mirror direction
    plus the fuzz ball (radius by :func:`cbrt_pos`), attenuated by the
    albedo. Dielectric: Schlick-weighted reflection or refraction,
    attenuation 1. Isotropic: a uniform direction, attenuated by the
    albedo. Families the scene lacks are skipped."""
    t = scene.mat_type[mat]
    p0 = scene.mat_params[mat][:, 0]
    ddn = dot(ray_dir, normal)
    refl = ray_dir - normal * (2.0 * ddn)[:, None]
    new_dir = refl
    att = torch.ones_like(ray_dir)
    kinds = flags.mat_kinds
    if _METAL in kinds or _ISO in kinds:
        alb = texture_value(scene, scene.mat_tex[mat], uv, p, flags)
    if _METAL in kinds:
        r_xy, phi, z = _sphere_dir(u[0], u[1])
        radius = cbrt_pos(torch.clamp(u[2], min=1e-12))
        ball = torch.stack([radius * r_xy * torch.cos(phi),
                            radius * r_xy * torch.sin(phi), radius * z], -1)
        mdir = _safe_normalize_rcp(refl + ball * p0[:, None])
        new_dir = where3(t == _METAL, mdir, new_dir)
        att = where3(t == _METAL, alb, att)
    if _DIEL in kinds:
        ref_idx = torch.clamp(p0, min=1e-2)
        going_out = ddn > 0.0
        out_n = where3(going_out, -normal, normal)
        ni_over_nt = torch.where(going_out, ref_idx, 1.0 / ref_idx)
        cosine = torch.where(going_out, ddn, -ddn)
        dt = dot(ray_dir, out_n)
        disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
        refr = ((ray_dir - out_n * dt[:, None]) * ni_over_nt[:, None]
                - out_n * grad_safe_sqrt(disc)[:, None])
        r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
        r0 = r0 * r0
        omc = torch.clamp(1.0 - cosine, min=0.0)
        omc2 = omc * omc
        schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
        reflect_prob = torch.where(disc > 0.0, schlick, 1.0)
        ddir = normalize(where3(u[3] < reflect_prob, refl, refr))
        new_dir = where3(t == _DIEL, ddir, new_dir)
    if _ISO in kinds:
        r_xy, phi, z = _sphere_dir(u[0], u[1])
        idir = normalize(torch.stack([r_xy * torch.cos(phi),
                                      r_xy * torch.sin(phi), z], -1))
        new_dir = where3(t == _ISO, idir, new_dir)
        att = where3(t == _ISO, alb, att)
    return new_dir, att


def face_basis(normal, ray_dir):
    """ONB about the normal oriented toward the viewer."""
    return onb_from_w(where3(dot(normal, ray_dir) > 0.0, -normal, normal))


class RawFrame(NamedTuple):
    """The parity estimator's Beckmann frame: the ONB about the raw stored
    normal, with no face-forward flip (``pdf.h:122-124``), ``wo``
    normalised in it, and the world ray direction ``d``, whose Lambda the
    stored pdf takes."""
    basis: tuple
    wo: torch.Tensor
    d: torch.Tensor


def raw_frame(normal, ray_dir) -> RawFrame:
    """:class:`RawFrame` of the stored ``normal`` (N, 3) and the incoming
    ``ray_dir``. On front hits it is the face frame; on backfacing and
    grazing hits it rotates the anisotropy ellipse, as the reference's."""
    basis = onb_from_w(normal)
    return RawFrame(basis, normalize(to_local(basis, -ray_dir)), ray_dir)


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
                flags: SceneFlags, raw: RawFrame | None = None):
    """World direction from the cosine lobe, or Beckmann's VNDF on
    Beckmann lanes (``pdf.h:30-59, 136-152``); under parity the VNDF in
    the ``raw`` frame with the broken Erf."""
    phi = 2.0 * math.pi * u1
    sq = torch.sqrt(u2)
    cos_dir = torch.stack([torch.cos(phi) * sq, torch.sin(phi) * sq,
                           torch.sqrt(torch.clamp(1.0 - u2, min=0.0))], -1)
    cos_world = normalize(to_world(basis, cos_dir))
    if _BECK not in flags.mat_kinds:
        return cos_world
    parity = flags.ref_parity
    b_basis, b_wo = (raw.basis, raw.wo) if parity else (basis, wo)
    ax, ay = _alphas(scene, mat)
    wh = sample_wh_visible(b_wo, ax, ay, u1, u2, parity)
    beck_wi = -b_wo + 2.0 * dot(b_wo, wh)[:, None] * wh
    beck_world = normalize(to_world(b_basis, beck_wi))
    return where3(scene.mat_type[mat] == _BECK, beck_world, cos_world)


def bsdf_pdf(scene: TorchScene, mat, basis, wo, wi_world,
             flags: SceneFlags, raw: RawFrame | None = None):
    """Density of :func:`sample_bsdf` at ``wi_world`` (for the mixture);
    under parity the value the reference stores: the full Oren–Nayar term
    on Oren–Nayar lanes, on Beckmann lanes ``beckmann_pdf::generate``'s
    ``D(wh)·G(d_world, wi)/(4|cosI||cosO|)`` in the ``raw`` frame,
    zeroed off its hemisphere (``pdf.h:144``)."""
    t = scene.mat_type[mat]
    wi = to_local(basis, wi_world)
    pdf = torch.clamp(wi[:, 2], min=0.0) * _INV_PI
    parity = flags.ref_parity
    if parity and _ON in flags.mat_kinds:
        params = scene.mat_params[mat]
        pdf = torch.where(t == _ON, _oren_nayar_term(wi, wo, params[:, 0],
                                                     params[:, 1]), pdf)
    if _BECK not in flags.mat_kinds:
        return pdf
    ax, ay = _alphas(scene, mat)
    if parity:
        wi_r = to_local(raw.basis, wi_world)
        wh_r = safe_normalize(wi_r + raw.wo)
        g_mixed = 1.0 / (1.0 + beckmann_lambda(raw.d, ax, ay)
                         + beckmann_lambda(wi_r, ax, ay))
        beck = (beckmann_d(wh_r, ax, ay) * g_mixed
                / torch.clamp(4.0 * torch.abs(wi_r[:, 2])
                              * torch.abs(raw.wo[:, 2]), min=1e-8))
        beck = torch.where(frame.same_hemisphere(raw.wo, wi_r), beck, 0.0)
        return torch.where(t == _BECK, beck, pdf)
    wh = safe_normalize(wi + wo)
    beck = gsdiv(pdf_wh_visible(wo, wh, ax, ay),
                 torch.clamp(4.0 * torch.abs(dot(wo, wh)), min=1e-8))
    beck = torch.where(frame.same_hemisphere(wo, wi), beck, 0.0)
    return torch.where(t == _BECK, beck, pdf)


def bsdf_weight(scene: TorchScene, mat, uv, p, basis, wo, wi_world,
                flags: SceneFlags, raw: RawFrame | None = None):
    """f(wo, wi) * |cosθi| — the reference's attenuation*scattering_pdf;
    under parity the plain cosine on Oren–Nayar lanes and, on Beckmann
    lanes, the VNDF density ``D·G1(wo)/(4|cosO|)`` in the ``raw`` frame
    with no same-hemisphere clamp (``material.h:134-138, 160-185``). On
    MERL lanes the measured table at the Rusinkiewicz index, tinted by the
    albedo (``brdf.h:106-214``, ``materials.py:329-336``)."""
    t = scene.mat_type[mat]
    params = scene.mat_params[mat]
    alb = texture_value(scene, scene.mat_tex[mat], uv, p, flags)
    wi = to_local(basis, wi_world)
    w = torch.clamp(wi[:, 2], min=0.0) * _INV_PI         # Lambertian
    parity = flags.ref_parity
    if _ON in flags.mat_kinds and not parity:
        w_on = _oren_nayar_term(wi, wo, params[:, 0], params[:, 1])
        w = torch.where(t == _ON, w_on, w)
    if _BECK in flags.mat_kinds and parity:
        wi_r = normalize(to_local(raw.basis, wi_world))
        wh_r = safe_normalize(wi_r + raw.wo)
        ax, ay = _alphas(scene, mat)
        w_beck = (beckmann_d(wh_r, ax, ay) * g1(raw.wo, ax, ay)
                  / torch.clamp(4.0 * torch.abs(raw.wo[:, 2]), min=1e-8))
        w = torch.where(t == _BECK, w_beck, w)
    elif _BECK in flags.mat_kinds:
        wh = safe_normalize(wi + wo)
        ax, ay = _alphas(scene, mat)
        w_beck = gsdiv(beckmann_d(wh, ax, ay) * g(wo, wi, ax, ay),
                       torch.clamp(4.0 * torch.abs(wo[:, 2]), min=1e-8))
        w_beck = torch.where(frame.same_hemisphere(wo, wi), w_beck, 0.0)
        w = torch.where(t == _BECK, w_beck, w)
    weight = alb * w[:, None]
    if scene.merl.shape[0] > 0:
        table_id = params[:, 0].to(torch.int32)
        f_merl = merl_mod.lookup(scene.merl, table_id, wo, wi)
        w_merl = alb * f_merl * torch.clamp(wi[:, 2], min=0.0)[:, None]
        weight = where3(t == _MERL, w_merl, weight)
    return weight
