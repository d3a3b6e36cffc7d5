"""One path-tracing bounce for a wavefront of lanes (counterpart of
``srt_tpu/render/integrator.py:167-368``; reference recursive estimator
``Raytracing_n.cpp:55-106``).

Covers the port's slices: sphere and box media (:func:`apply_media`),
the specular branch of metal, dielectric and isotropic materials,
textures at the hit's uv and position, rect and sphere lights, no parity
mode. The diffuse branch is the reference's 50/50 mixture of light
sampling and BSDF sampling with its closed-form mixture pdf; Russian
roulette is ours and off when ``rr_start >= max_depth``.
"""
from __future__ import annotations

import torch

from srt_tpu_torch.core import rng
from srt_tpu_torch.core.gradsafe import grad_safe_sqrt, gsdiv
from srt_tpu_torch.core.vecmath import dot, to_local, where3
from srt_tpu_torch.materials import materials as mats
from srt_tpu_torch.render import lights
from srt_tpu_torch.render.intersect import Hit, _ray_at, intersect_scene
from srt_tpu_torch.scene.ir import SPECULAR_MATS, SceneFlags, TorchScene

# Static sampler dimension slots per bounce (one decision per slot).
DIM_MEDIUM = 0        # free flight, one per medium (+ its index)
DIM_SPEC = 8          # the specular branch's four uniforms
DIM_MIX = 12          # light-vs-bsdf pick
DIM_LIGHT_PICK = 13
DIM_SAMPLE = 14       # u1, u2 for light point / bsdf lobe
DIM_RR = 16           # russian roulette


def apply_media(scene: TorchScene, o, d, salt, hit: Hit) -> Hit:
    """Override the surface hit with a nearer in-scatter event, medium by
    medium: exponential free flight through a sphere- or box-bounded
    homogeneous medium (``constant_medium.h:19-50``), in the forms of the
    JAX kernel's ``_media_sweep`` (``srt_tpu/pallas/bounce.py:486-542``).
    An event is a hit on the medium's isotropic material with normal +x
    and uv 0. The root and the slabs' reciprocals take the kernel
    backward's ``safe_ad`` forms (:func:`grad_safe_sqrt`, :func:`gsdiv`):
    the same values, and no NaN gradient on a lane that misses the medium.
    Mesh-bounded media are outside the coverage gate."""
    g = torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    inv = gsdiv(1.0, g)
    n = o.shape[0]
    for m in range(scene.n_media):
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
        if int(scene.med_kind[m]) == 1:
            t_in, t_out, ok = b_in, b_out, b_out > b_in
        else:
            t_in, t_out, ok = -bq - sq, -bq + sq, disc > 0.0
        # maximum, not clamp: half the gradient on a tie (a ray that
        # starts on the medium's face), as jnp.maximum's
        t_enter = torch.maximum(t_in, torch.zeros_like(t_in))
        t_exit = torch.minimum(t_out, hit.t)
        inside = ok & (t_exit > t_enter)
        u = torch.clamp(rng.uniform(salt, DIM_MEDIUM + m), min=1e-12)
        free = -torch.log(u) / scene.med_density[m]
        t_sc = t_enter + free
        event = inside & (free < (t_exit - t_enter)) & (t_sc < hit.t)
        normal = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
        normal[:, 0] = 1.0
        hit = hit.closer_of(Hit(
            t=t_sc, hit=event, p=_ray_at(o, d, t_sc), normal=normal,
            uv=torch.zeros((n, 2), dtype=o.dtype, device=o.device),
            mat=scene.med_mat[m].long().expand(n)))
    return hit


def bounce_step(scene: TorchScene, state: dict, max_depth: int,
                rr_start: int, flags: SceneFlags,
                pdf_floor: float = 1e-9, tri=None, sph=None) -> dict:
    """``state`` keys: ``o d (N,3) f32, time (N,) f32, beta radiance (N,3)
    f32, alive (N,) bool, salt (N,) 32-bit words (any int dtype), depth
    (N,) int32``. ``tri``: the triangles' closest hit ``(t, u, v, tri)``,
    ``sph``: the spheres' winner ``(t, idx)``, if the caller has them (see
    ``intersect_scene``). Returns the next state (``alive`` does not yet
    fold in the depth cap; the caller does)."""
    depth = state["depth"]
    salt = rng.hash_combine(rng.as_word(state["salt"]), rng.as_word(depth))
    o, d = state["o"], state["d"]
    alive, beta = state["alive"], state["beta"]

    hit = intersect_scene(scene, o, d, 1e-3, tri, flags.bvh_leaf,
                          state["time"], sph)
    if scene.n_media:
        hit = apply_media(scene, o, d, salt, hit)
    # sanitize miss lanes: zero normal -> +z, far position -> origin
    up = torch.zeros_like(hit.normal)
    up[:, 2] = 1.0
    p = where3(hit.hit, hit.p, o)
    normal = where3(hit.hit & (dot(hit.normal, hit.normal) > 1e-12),
                    hit.normal, up)

    # emission, added whether or not the path continues
    emit = mats.emitted(scene, hit.mat, hit.uv, p, normal, d, flags)
    radiance = state["radiance"] + torch.where((alive & hit.hit)[:, None],
                                               beta * emit, 0.0)
    scatters = hit.hit & mats.is_scattering(scene, hit.mat)

    # diffuse branch: mixture-pdf NEE (Raytracing_n.cpp:71-94)
    basis = mats.face_basis(normal, d)
    wo = to_local(basis, -d)
    u1 = rng.uniform(salt, DIM_SAMPLE)
    u2 = rng.uniform(salt, DIM_SAMPLE + 1)
    wi = mats.sample_bsdf(scene, hit.mat, basis, wo, u1, u2, flags)
    if scene.n_lights:
        light_dir = lights.sample_lights(
            scene, p, rng.uniform(salt, DIM_LIGHT_PICK), u1, u2)
        wi = where3(rng.uniform(salt, DIM_MIX) < 0.5, light_dir, wi)
    pdf = mats.bsdf_pdf(scene, hit.mat, basis, wo, wi, flags)
    if scene.n_lights:
        pdf = 0.5 * lights.lights_pdf(scene, p, wi) + 0.5 * pdf
    weight = mats.bsdf_weight(scene, hit.mat, hit.uv, p, basis, wo, wi,
                              flags)
    # below-floor pdfs contribute zero (the reference retries instead)
    diff_beta = torch.where((pdf > pdf_floor)[:, None],
                            gsdiv(weight,
                                  torch.clamp(pdf, min=pdf_floor)[:, None]),
                            0.0)

    # specular branch (Raytracing_n.cpp:66-70), on the stored normal
    if set(flags.mat_kinds) & SPECULAR_MATS:
        u_spec = [rng.uniform(salt, DIM_SPEC + i) for i in range(4)]
        spec_dir, spec_att = mats.scatter_specular(
            scene, hit.mat, hit.uv, p, normal, d, u_spec, flags)
        specular = scatters & mats.is_specular(scene, hit.mat)
        wi = where3(specular, spec_dir, wi)
        diff_beta = where3(specular, spec_att, diff_beta)

    new_beta = beta * diff_beta
    beta_max = new_beta.max(-1).values
    new_alive = alive & scatters & (beta_max > 0.0)
    if rr_start < max_depth:
        q = torch.clamp(beta_max, 0.05, 1.0)
        survive = rng.uniform(salt, DIM_RR) < q
        new_alive = new_alive & ((depth < rr_start) | survive)
        new_beta = torch.where((new_alive & (depth >= rr_start))[:, None],
                               new_beta / q[:, None], new_beta)

    upd = (alive & scatters)[:, None]
    return dict(o=torch.where(upd, p, o), d=torch.where(upd, wi, d),
                time=state["time"],
                beta=torch.where(alive[:, None], new_beta, beta),
                radiance=radiance, alive=new_alive & alive,
                salt=state["salt"], depth=depth + 1)
