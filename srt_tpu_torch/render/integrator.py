"""One path-tracing bounce for a wavefront of lanes (counterpart of
``srt_tpu/render/integrator.py:167-368``; reference recursive estimator
``Raytracing_n.cpp:55-106``).

Covers the port's slices: sphere, box and mesh-bounded media
(:func:`apply_media`),
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
from srt_tpu_torch.core.vecmath import cross, dot, to_local, where3
from srt_tpu_torch.materials import materials as mats
from srt_tpu_torch.render import lights
from srt_tpu_torch.render.intersect import (BIG, Hit, _ray_at,
                                            intersect_scene)
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
#: a mesh medium's boundary triangles are tested in chunks of this many
#: (``srt_tpu/render/integrator.py:61``; the pair of nearest crossings is
#: merged chunk by chunk, so the chunking is part of the result) ...
MESH_TRI_CHUNK = 512
#: ... against at most this many (lane, triangle) pairs at a time: the
#: scan engine's 524,288 lanes against one 512-triangle chunk would be
#: over 1 GB a temporary
MESH_PAIRS = 1 << 22
#: the host reads "any lane alive" from the device once every this many
#: bounces, in the regeneration loops and the sequential parity mode
CHECK_EVERY = 8


def _mesh_crossings_chunk(scene: TorchScene, o, d, m: int):
    """:func:`mesh_medium_crossings` for one chunk of lanes."""
    n = o.shape[0]
    t1 = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
    t2 = t1.clone()
    k = scene.med_tri_p0.shape[0]
    chunk = min(MESH_TRI_CHUNK, k)
    for c0 in range(0, k, chunk):
        p0 = scene.med_tri_p0[c0:c0 + chunk]
        e1 = scene.med_tri_p1[c0:c0 + chunk] - p0
        e2 = scene.med_tri_p2[c0:c0 + chunk] - p0
        mine = scene.med_tri_mid[c0:c0 + chunk] == m
        dv = d[:, None, :]
        pv = cross(dv, e2[None])
        det = dot(e1[None], pv)
        inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
        tv = o[:, None, :] - p0[None]
        u = dot(tv, pv) * inv
        qv = cross(tv, e1[None])
        v = dot(dv, qv) * inv
        t = dot(e2[None], qv) * inv
        # two-sided, any sign of t: a ray that starts inside clamps its
        # entry to 0 in apply_media
        valid = (mine[None] & (torch.abs(det) > 1e-10) & (u >= 0.0)
                 & (v >= 0.0) & (u + v <= 1.0) & (t > -1e30))
        tt = torch.where(valid, t, BIG)
        # merge this chunk's two smallest into the running (t1, t2)
        c_min = tt.min(1).values
        c_second = torch.where(tt <= c_min[:, None] + 1e-4, BIG,
                               tt).min(1).values
        all4 = torch.stack([t1, t2, c_min, c_second], 1)
        t1 = all4.min(1).values
        t2 = torch.where(all4 <= t1[:, None] + 1e-4, BIG, all4).min(1).values
    return t1, t2


def mesh_medium_crossings(scene: TorchScene, o, d, m: int):
    """``(t_in, t_out, ok)`` of medium ``m``'s triangle boundary
    (``srt_tpu/render/integrator.py:48-106``): the smallest and
    second-smallest signed crossing, which for a convex boundary are the
    reference's first crossing from -FLT_MAX and the next after it
    (``constant_medium.h:23-27``, ``triangle.h:108-115``). The triangles
    go in :data:`MESH_TRI_CHUNK` chunks, the lanes in chunks of at most
    :data:`MESH_PAIRS` pairs with a triangle chunk; a lane's result does
    not depend on the lane chunking."""
    k = scene.med_tri_p0.shape[0]
    lanes = max(1, MESH_PAIRS // min(MESH_TRI_CHUNK, k))
    parts = [_mesh_crossings_chunk(scene, o[l0:l0 + lanes],
                                   d[l0:l0 + lanes], m)
             for l0 in range(0, o.shape[0], lanes)]
    t1 = torch.cat([p[0] for p in parts])
    t2 = torch.cat([p[1] for p in parts])
    return t1, t2, (t1 < BIG) & (t2 < BIG)


def apply_media(scene: TorchScene, o, d, salt, hit: Hit) -> Hit:
    """Override the surface hit with a nearer in-scatter event, medium by
    medium: exponential free flight through a sphere- or box-bounded
    homogeneous medium (``constant_medium.h:19-50``), in the forms of the
    JAX kernel's ``_media_sweep`` (``srt_tpu/pallas/bounce.py:486-542``).
    An event is a hit on the medium's isotropic material with normal +x
    and uv 0. The root and the slabs' reciprocals take the kernel
    backward's ``safe_ad`` forms (:func:`grad_safe_sqrt`, :func:`gsdiv`):
    the same values, and no NaN gradient on a lane that misses the medium.
    A mesh-bounded medium takes its crossings from
    :func:`mesh_medium_crossings` when the scene has boundary triangles;
    without them it takes the sphere's, as the JAX integrator does."""
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
        kind = int(scene.med_kind[m])
        if kind == 1:
            t_in, t_out, ok = b_in, b_out, b_out > b_in
        elif kind == 2 and scene.med_tri_p0 is not None:
            t_in, t_out, ok = mesh_medium_crossings(scene, o, d, m)
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
    ``intersect_scene``; without ``sph``, ``flags.sphere_bvh`` walks the
    sphere BVH). Returns the next state (``alive`` does not yet fold in
    the depth cap; the caller does).

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
                          state["time"], sph, flags.sphere_bvh,
                          flags.sbvh_leaf)
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


def scrub_nan(radiance: torch.Tensor) -> torch.Tensor:
    """NaN radiance channels set to 0 (de_nan, ``Raytracing_n.cpp:47-53``)."""
    return torch.where(torch.isnan(radiance), 0.0, radiance)


def initial_state(rays, salt: torch.Tensor, parity: bool = False,
                  stale0=None) -> dict:
    """The wavefront state of fresh primary rays ``(origin, direction,
    time)`` with sampler salts: unit throughput, no radiance, every lane
    alive at depth 0; under ``parity`` the ``stale`` plane ``stale0``
    (zeros when None)."""
    o, d, time = rays
    n = o.shape[0]
    dev = o.device
    state = dict(o=o, d=d, time=time,
                 beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
                 radiance=torch.zeros((n, 3), dtype=torch.float32,
                                      device=dev),
                 alive=torch.ones((n,), dtype=torch.bool, device=dev),
                 salt=salt.to(torch.int32),     # the words' bit patterns
                 depth=torch.zeros((n,), dtype=torch.int32, device=dev))
    if parity:
        state["stale"] = (stale0 if stale0 is not None else
                          torch.zeros((n,), dtype=torch.float32, device=dev))
    return state


def trace(step, rays, salt: torch.Tensor, *, max_depth: int,
          parity: bool = False, with_aux: bool = False, stale0=None,
          return_stale: bool = False):
    """Estimate radiance for a wavefront of primary rays ``(origin (N,3),
    direction (N,3), time (N,))`` with sampler salts (N,) -> (N, 3), the
    scan engine (counterpart of ``srt_tpu/render/integrator.py:371-455``):
    ``max_depth`` bounces of ``step`` (state -> next state, e.g. a
    :class:`render.route.Route`) with every lane in depth lockstep, then
    the NaN scrub. The bounce count is the depth cap, so lanes still
    alive after it keep the radiance they gathered.

    ``with_aux`` also returns the device-side counters ``alive_per_bounce``
    (max_depth,), ``path_vertices`` and ``nan_scrubbed``. Under ``parity``
    the state carries the ``stale`` plane from ``stale0`` (zeros when
    None); ``return_stale`` returns it beside the radiance (the sequential
    parity mode, ``RenderConfig.seq_stale``) and stops once no lane is
    alive, read from the device every :data:`CHECK_EVERY` bounces (a bounce of
    an all-dead wavefront changes no radiance)."""
    state = initial_state(rays, salt, parity, stale0)
    if return_stale:
        if with_aux:
            raise ValueError("return_stale and with_aux are exclusive")
        done = 0
        while done < max_depth:
            for _ in range(min(CHECK_EVERY, max_depth - done)):
                state = step(state)
            done = min(done + CHECK_EVERY, max_depth)
            if done < max_depth and not bool(state["alive"].any()):
                break
        return scrub_nan(state["radiance"]), state.get("stale")
    alive_hist = []
    for _ in range(max_depth):
        if with_aux:
            alive_hist.append(state["alive"].sum())
        state = step(state)
    radiance = state["radiance"]
    if not with_aux:
        return scrub_nan(radiance)
    hist = torch.stack(alive_hist)
    return scrub_nan(radiance), dict(
        alive_per_bounce=hist, path_vertices=hist.sum(),
        nan_scrubbed=torch.isnan(radiance).sum())
