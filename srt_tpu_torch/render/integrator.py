"""One path-tracing bounce for a wavefront of lanes (counterpart of
``srt_tpu/render/integrator.py:167-368``; reference recursive estimator
``Raytracing_n.cpp:55-106``).

Covers the port's slices: sphere and box media (:func:`apply_media`),
the specular branch of metal, dielectric and isotropic materials,
textures at the hit's uv and position, rect and sphere lights, and the
reference-parity estimator (:func:`parity_draw`). The diffuse branch is
the reference's 50/50 mixture of light sampling and BSDF sampling with
its closed-form mixture pdf; Russian roulette is ours and off when
``rr_start >= max_depth``.
"""
from __future__ import annotations

import torch

from srt_tpu_torch.core import rng
from srt_tpu_torch.core.gradsafe import grad_safe_sqrt, gsdiv
from srt_tpu_torch.core.vecmath import dot, to_local, where3
from srt_tpu_torch.materials import materials as mats
from srt_tpu_torch.render import lights
from srt_tpu_torch.render.intersect import Hit, _ray_at, intersect_scene
from srt_tpu_torch.scene.ir import (SPECULAR_MATS, MaterialType, SceneFlags,
                                    TorchScene)

# Static sampler dimension slots per bounce (one decision per slot).
DIM_MEDIUM = 0        # free flight, one per medium (+ its index)
DIM_SPEC = 8          # the specular branch's four uniforms
DIM_MIX = 12          # light-vs-bsdf pick
DIM_LIGHT_PICK = 13
DIM_SAMPLE = 14       # u1, u2 for light point / bsdf lobe
DIM_RR = 16           # russian roulette
DIM_RETRY = 17        # parity resample rounds (4 dims each: mix, pick, u1, u2)
DIM_SLOT = 33         # parity heap-slot Bernoulli
#: parity: resample rounds after the first draw (the JAX integrator reads
#: ``SRT_TPU_PARITY_RETRIES``, default 4; the port fixes it)
PARITY_RETRIES = 4
#: parity: the share of heap-slot reads that see 0.0, and the garbage the
#: others read (``srt_tpu/render/integrator.py:38-45``, GOLDEN.md r5)
PARITY_SLOT_ZERO_P = 0.086
PARITY_KILL = 1e30


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


def parity_slot(salt, flags: SceneFlags):
    """The heap slot's value at the start of a bounce: 0.0 with
    probability :data:`PARITY_SLOT_ZERO_P`, else :data:`PARITY_KILL`, drawn
    on dimension :data:`DIM_SLOT` of the bounce's ``salt``; 0.0 on every
    lane under ``parity_no_stale``. The slot never carries across bounces:
    ``free()`` overwrites the reference's slot between them."""
    if flags.parity_no_stale:
        return torch.zeros(salt.shape, dtype=torch.float32,
                           device=salt.device)
    return torch.where(rng.uniform(salt, DIM_SLOT) < PARITY_SLOT_ZERO_P,
                       0.0, PARITY_KILL)


def parity_draw(scene: TorchScene, flags: SceneFlags, mat, p, basis, wo,
                raw, salt, slot, trace: list | None = None):
    """The reference-parity mixture draw (``srt_tpu/render/integrator.py:
    225-330``) -> ``(wi, pdf, slot)``. Lambertian and Oren–Nayar lanes
    always take the light sample (the reference's BSDF lobe is flipped
    into the surface, so its ``while (pdf == 0)`` loop retries until the
    light is picked); Beckmann lanes that take the light read the heap
    ``slot`` in place of their BSDF pdf, and a round that takes the
    Beckmann BSDF stores its pdf there. Lanes whose pdf is not positive
    redraw on fresh dimensions (``DIM_RETRY + 4(r-1)``) for up to
    :data:`PARITY_RETRIES` rounds; a lane with a positive pdf keeps its
    draw. ``trace``, if given, receives one dict a round of the lanes that
    drew (``need``), took the light (``pick_light``) and the slot they
    drew with (``slot``), for diagnostics."""
    t = scene.mat_type[mat]
    is_beck = t == int(MaterialType.BECKMANN)
    light_only = ((t == int(MaterialType.LAMBERTIAN))
                  | (t == int(MaterialType.OREN_NAYAR)))
    need = torch.ones_like(is_beck)
    wi, pdf = torch.zeros_like(p), torch.zeros_like(p[:, 0])
    for rnd in range(1 + PARITY_RETRIES):
        base = DIM_RETRY + 4 * (rnd - 1)
        dim_mix, dim_pick, dim_s = ((DIM_MIX, DIM_LIGHT_PICK, DIM_SAMPLE)
                                    if rnd == 0 else
                                    (base, base + 1, base + 2))
        u1 = rng.uniform(salt, dim_s)
        u2 = rng.uniform(salt, dim_s + 1)
        bsdf_dir = mats.sample_bsdf(scene, mat, basis, wo, u1, u2, flags,
                                    raw)
        if scene.n_lights:
            light_dir = lights.sample_lights(
                scene, p, rng.uniform(salt, dim_pick), u1, u2)
            pick_light = (rng.uniform(salt, dim_mix) < 0.5) | light_only
            wi_r = where3(pick_light, light_dir, bsdf_dir)
            bpdf = mats.bsdf_pdf(scene, mat, basis, wo, wi_r, flags, raw)
            # at the sampled direction the pdf is the one the BSDF draw
            # stores in the slot
            took_bsdf = is_beck & ~pick_light
            slot_r = torch.where(took_bsdf, mats.bsdf_pdf(
                scene, mat, basis, wo, bsdf_dir, flags, raw), slot)
            bpdf = torch.where(is_beck & pick_light, slot, bpdf)
            pdf_r = 0.5 * lights.lights_pdf(scene, p, wi_r) + 0.5 * bpdf
        else:
            pick_light = torch.zeros_like(need)
            wi_r = bsdf_dir
            pdf_r = mats.bsdf_pdf(scene, mat, basis, wo, wi_r, flags, raw)
            slot_r = slot
        if trace is not None:
            trace.append(dict(need=need, pick_light=pick_light, slot=slot))
        wi = where3(need, wi_r, wi)
        pdf = torch.where(need, pdf_r, pdf)
        slot = torch.where(need, slot_r, slot)
        need = need & (pdf <= 0.0)
    return wi, pdf, slot


def bounce_step(scene: TorchScene, state: dict, max_depth: int,
                rr_start: int, flags: SceneFlags,
                pdf_floor: float = 1e-9, tri=None, sph=None,
                trace: list | None = None) -> dict:
    """``state`` keys: ``o d (N,3) f32, time (N,) f32, beta radiance (N,3)
    f32, alive (N,) bool, salt (N,) 32-bit words (any int dtype), depth
    (N,) int32``. ``tri``: the triangles' closest hit ``(t, u, v, tri)``,
    ``sph``: the spheres' winner ``(t, idx)``, if the caller has them (see
    ``intersect_scene``). Returns the next state (``alive`` does not yet
    fold in the depth cap; the caller does).

    Under ``flags.ref_parity`` the diffuse branch is :func:`parity_draw`
    with the reference's BSDF forms (``materials.RawFrame``), and the next
    state has ``stale`` (N,) f32: the heap slot after the bounce's draw on
    the lanes that drew (live diffuse hits), its starting value
    (:func:`parity_slot`) on the others. An incoming ``stale`` is not
    read, as in the JAX kernel (``pallas/bounce.py:966-970``). ``trace``
    goes to :func:`parity_draw`."""
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
    raw = None
    if flags.ref_parity:
        raw = mats.raw_frame(normal, d)
        slot0 = parity_slot(salt, flags)
        wi, pdf, slot = parity_draw(scene, flags, hit.mat, p, basis, wo, raw,
                                    salt, slot0, trace)
    else:
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
                              flags, raw)
    # below-floor pdfs contribute zero (the reference retries instead)
    diff_beta = torch.where((pdf > pdf_floor)[:, None],
                            gsdiv(weight,
                                  torch.clamp(pdf, min=pdf_floor)[:, None]),
                            0.0)

    # specular branch (Raytracing_n.cpp:66-70), on the stored normal
    specular = torch.zeros_like(scatters)
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
    out = dict(o=torch.where(upd, p, o), d=torch.where(upd, wi, d),
               time=state["time"],
               beta=torch.where(alive[:, None], new_beta, beta),
               radiance=radiance, alive=new_alive & alive,
               salt=state["salt"], depth=depth + 1)
    if flags.ref_parity:
        out["stale"] = torch.where(alive & scatters & ~specular, slot, slot0)
    return out
