"""Shading of the sphere family's materials: textures (constant, checker,
image), the anisotropic Beckmann microfacet distribution, emission, the
BSDFs' sample, pdf and weight, the specular branch, and next-event light
sampling over rect and sphere lights.

A frozen copy of ``srt_tpu_torch/materials/{textures,microfacet,
materials}.py`` and ``srt_tpu_torch/render/lights.py`` as they stood when
the benchmark was written, without what the benchmark's configurations do
not hold (the reference-parity estimator's forms, MERL tables, Perlin
noise): a configuration that needs one adds it here, and a scene that
holds one is refused (:func:`benchmark.reference.scene.Scene`).
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.core import (acos_as, cbrt_pos, cos2_theta,
                                      cos_phi, dot, erf_as, erfinv_giles,
                                      grad_safe_sqrt, gsdiv, gsrecip,
                                      normalize, onb_from_w, safe_normalize,
                                      safe_sqrt, same_hemisphere, sin_phi,
                                      sin_theta, tan2_theta, tan_theta,
                                      to_local, to_world, where3)
from benchmark.reference.scene import (SPECULAR_MATS, LightKind,
                                       MaterialType, TextureType)
from benchmark.reference.spheres import RECT_NAXIS, RECT_UAXIS, RECT_VAXIS

# --- textures (srt_tpu_torch/materials/textures.py) ---------------------

def image_value(scene, tex_id, u, v):
    """Nearest-neighbor lookup with y-flip (``texture.h:58-70``,
    ``textures.py:_image_value``): in the packed rgb8 atlas ``atlas_u32``
    where the scene has one (``int(c) / 255`` in float32 gives back the
    build-time ``u8 / 255`` values exactly), else in the float atlas,
    three gathers whose cotangents reach the texels (an optimised atlas,
    :func:`diff.inverse.splice`, drops the packed twin)."""
    meta = scene.tex_img[tex_id]              # (N, 3) offset, nx, ny
    off, nx, ny = meta[:, 0], meta[:, 1], meta[:, 2]
    i = torch.minimum(torch.clamp((u * nx.to(u.dtype)).to(torch.int32),
                                  min=0), nx - 1)
    j = torch.minimum(torch.clamp(((1.0 - v) * ny.to(v.dtype) - 0.001)
                                  .to(torch.int32), min=0), ny - 1)
    if scene.atlas.shape[0] == 0:
        return torch.ones((u.shape[0], 3), dtype=torch.float32,
                          device=u.device)
    if scene.atlas_u32 is None:
        base = torch.clamp(off + 3 * (i + nx * j), 0,
                           scene.atlas.shape[0] - 3).long()
        return torch.stack([scene.atlas[base], scene.atlas[base + 1],
                            scene.atlas[base + 2]], -1)
    base3 = torch.clamp(off // 3 + i + nx * j, 0,
                        scene.atlas_u32.shape[0] - 1)
    bits = scene.atlas_u32[base3.long()]
    return torch.stack([((bits >> 16) & 255).to(torch.float32) / 255.0,
                        ((bits >> 8) & 255).to(torch.float32) / 255.0,
                        (bits & 255).to(torch.float32) / 255.0], -1)


def checker(p):
    """The checker's parity: True where the product of ``sin(10 x)`` over
    the three axes is negative, the odd colour (``texture.h:13-19``)."""
    s = torch.sin(10.0 * p)
    return s[:, 0] * s[:, 1] * s[:, 2] < 0.0


def texture_value(scene, tex_id, uv, p, flags):
    """Colour of texture ``tex_id`` (N,) at hit uv (N, 2) and hit point
    ``p`` (N, 3) -> (N, 3). Families the scene lacks are skipped."""
    ttype = scene.tex_type[tex_id]
    color = scene.tex_color[tex_id]
    out = color
    kinds = flags.tex_kinds
    if int(TextureType.CHECKER) in kinds:
        odd = checker(p)
        chk = torch.where(odd[:, None], scene.tex_color2[tex_id], color)
        out = torch.where((ttype == int(TextureType.CHECKER))[:, None], chk,
                          out)
    if int(TextureType.IMAGE) in kinds:
        image = image_value(scene, tex_id, uv[:, 0], uv[:, 1])
        out = torch.where((ttype == int(TextureType.IMAGE))[:, None], image,
                          out)
    return out


# --- Beckmann (srt_tpu_torch/materials/microfacet.py) ------------------

_SQRT_PI_INV = 0.5641895835477563


def beckmann_d(wh, alphax, alphay):
    """Anisotropic Beckmann NDF; ``tan2`` clamped finite before the exp."""
    tan2 = torch.clamp(tan2_theta(wh), max=1e8)
    cos2 = cos2_theta(wh)
    cos4 = cos2 * cos2
    cp, sp = cos_phi(wh), sin_phi(wh)
    e = torch.exp(-tan2 * (cp * cp / (alphax * alphax)
                           + sp * sp / (alphay * alphay)))
    d = gsdiv(e, math.pi * alphax * alphay * torch.clamp(cos4, min=1e-16))
    return torch.where(tan2 < 1e8, d, 0.0)


def beckmann_lambda(w, alphax, alphay):
    """Rational-approx Lambda, evaluated on a clamped argument."""
    abs_tan = torch.clamp(torch.abs(tan_theta(w)), max=1e8)
    cp, sp = cos_phi(w), sin_phi(w)
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


def _beckmann_sample11(cos_theta_i, u1, u2):
    """P22 slopes for the normal-incidence-stretched direction
    (``BeckmannSample11``, ``microfacet_distribution.h:34-107``): up to 9
    Newton-bisection steps in the erf domain; a lane freezes once
    |value| < 1e-5, as the reference breaks out."""
    r = torch.sqrt(-torch.log1p(-torch.clamp(u1, max=1.0 - 1e-7)))
    phi = 2.0 * math.pi * u2
    sx_normal = r * torch.cos(phi)
    sy_normal = r * torch.sin(phi)

    cos_t = torch.clamp(cos_theta_i, -1.0, 1.0)
    sin_t = grad_safe_sqrt(1.0 - cos_t * cos_t)
    tan_t = gsdiv(sin_t, torch.clamp(cos_t, min=1e-20))
    cot_t = gsrecip(torch.clamp(tan_t, min=1e-20))

    a = torch.full_like(u1, -1.0)
    c = erf_as(cos_t)
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


def sample_wh_visible(wo, alphax, alphay, u1, u2):
    """Visible-normal Beckmann sampling: stretch, sample P22 slopes,
    rotate, unstretch, renormalize."""
    flip = wo[..., 2] < 0.0
    wi = torch.where(flip[..., None], -wo, wo)
    st = torch.stack([alphax * wi[..., 0], alphay * wi[..., 1], wi[..., 2]],
                     -1)
    # divide, not multiply by the reciprocal: one ulp here flips the
    # cosThetaI > 0.9999 normal-incidence branch
    st = gsdiv(st, torch.clamp(torch.sqrt(
        st[..., 0] * st[..., 0] + st[..., 1] * st[..., 1]
        + st[..., 2] * st[..., 2]), min=1e-20)[..., None])
    sx, sy = _beckmann_sample11(st[..., 2], u1, u2)
    cp, sp = cos_phi(st), sin_phi(st)
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


# --- materials (srt_tpu_torch/materials/materials.py) ------------------

_INV_PI = 1.0 / math.pi
_BECK = int(MaterialType.BECKMANN)
_METAL = int(MaterialType.METAL)
_DIEL = int(MaterialType.DIELECTRIC)
_ISO = int(MaterialType.ISOTROPIC)
_ON = int(MaterialType.OREN_NAYAR)


def _alphas(scene, mat):
    """Beckmann alphas, floored: other materials' lanes read zeros."""
    params = scene.mat_params[mat]
    return (torch.where(params[:, 0] > 1e-4, params[:, 0], 1e-4),
            torch.where(params[:, 1] > 1e-4, params[:, 1], 1e-4))


def emitted(scene, mat, uv, p, normal, ray_dir,
            flags):
    """One-sided emission (``material.h:348-354``): only where the stored
    normal faces the incoming ray."""
    is_light = scene.mat_type[mat] == int(MaterialType.DIFFUSE_LIGHT)
    facing = dot(normal, ray_dir) < 0.0
    e = texture_value(scene, scene.mat_tex[mat], uv, p, flags)
    return torch.where((is_light & facing)[:, None], e, 0.0)


def is_scattering(scene, mat):
    """False only for pure emitters (``material.h:344``)."""
    return scene.mat_type[mat] != int(MaterialType.DIFFUSE_LIGHT)


def is_specular(scene, mat):
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


def scatter_specular(scene, mat, uv, p, normal, ray_dir, u,
                     flags):
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


def _oren_nayar_term(wi, wo, a, b):
    """cosI * (A + B*maxCos*sinAlpha*tanBeta) / pi (``pdf.h:64-101``)."""
    sin_ti, sin_to = sin_theta(wi), sin_theta(wo)
    d_cos = (cos_phi(wi) * cos_phi(wo)
             + sin_phi(wi) * sin_phi(wo))
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


def sample_bsdf(scene, mat, basis, wo, u1, u2, flags):
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


def bsdf_pdf(scene, mat, basis, wo, wi_world, flags):
    """Density of :func:`sample_bsdf` at ``wi_world`` (for the mixture)."""
    t = scene.mat_type[mat]
    wi = to_local(basis, wi_world)
    pdf = torch.clamp(wi[:, 2], min=0.0) * _INV_PI
    if _BECK not in flags.mat_kinds:
        return pdf
    ax, ay = _alphas(scene, mat)
    wh = safe_normalize(wi + wo)
    beck = gsdiv(pdf_wh_visible(wo, wh, ax, ay),
                 torch.clamp(4.0 * torch.abs(dot(wo, wh)), min=1e-8))
    beck = torch.where(same_hemisphere(wo, wi), beck, 0.0)
    return torch.where(t == _BECK, beck, pdf)


def bsdf_weight(scene, mat, uv, p, basis, wo, wi_world, flags):
    """f(wo, wi) * |cos(theta_i)|, the reference's
    attenuation*scattering_pdf."""
    t = scene.mat_type[mat]
    params = scene.mat_params[mat]
    alb = texture_value(scene, scene.mat_tex[mat], uv, p, flags)
    wi = to_local(basis, wi_world)
    w = torch.clamp(wi[:, 2], min=0.0) * _INV_PI         # Lambertian
    if _ON in flags.mat_kinds:
        w_on = _oren_nayar_term(wi, wo, params[:, 0], params[:, 1])
        w = torch.where(t == _ON, w_on, w)
    if _BECK in flags.mat_kinds:
        wh = safe_normalize(wi + wo)
        ax, ay = _alphas(scene, mat)
        w_beck = gsdiv(beckmann_d(wh, ax, ay) * g(wo, wi, ax, ay),
                       torch.clamp(4.0 * torch.abs(wo[:, 2]), min=1e-8))
        w_beck = torch.where(same_hemisphere(wo, wi), w_beck, 0.0)
        w = torch.where(t == _BECK, w_beck, w)
    return alb * w[:, None]


# --- lights (srt_tpu_torch/render/lights.py) ---------------------------

def _rect(scene, ridx: int):
    """Host-side record of rect ``ridx``: axes, plane, bounds."""
    axis = int(scene.rect_axis[ridx])
    return (RECT_NAXIS[axis], RECT_UAXIS[axis], RECT_VAXIS[axis],
            scene.rect_k[ridx], scene.rect_bounds[ridx])


def _lights(scene):
    """``(kind, index)`` of each light, read on the host."""
    return list(zip(scene.light_kind.tolist(), scene.light_index.tolist()))


def _rect_sample(scene, ridx: int, p, u1, u2):
    """A unit direction toward a uniform point on the rect."""
    na, ua, va, k, b = _rect(scene, ridx)
    point = torch.empty_like(p)
    point[:, na] = k
    point[:, ua] = b[0] + u1 * (b[1] - b[0])
    point[:, va] = b[2] + u2 * (b[3] - b[2])
    return normalize(point - p)


def _rect_pdf(scene, ridx: int, p, wi):
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


def _sphere_sample(scene, sidx: int, p, u1, u2):
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


def _sphere_pdf(scene, sidx: int, p, wi):
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


def sample_lights(scene, p, u_pick, u1, u2):
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


def lights_pdf(scene, p, wi):
    """Uniform-mixture solid-angle pdf over all lights
    (``hitable_list::pdf_value``, ``hitable_list.h:54-62``)."""
    acc = torch.zeros_like(p[:, 0])
    for kind, idx in _lights(scene):
        pdf = _rect_pdf if kind == int(LightKind.RECT) else _sphere_pdf
        acc = acc + pdf(scene, idx, p, wi)
    return acc / scene.n_lights
