"""The plain reference's estimator: one bounce of a wavefront of paths,
the paths of chosen pixels traced to the depth cap, and the train step's
loss, gradient and Adam update.

The bounce is a frozen copy of ``srt_tpu_torch/render/integrator.py:
bounce_step`` without what the benchmark's configurations do not hold (the
parity estimator, the sphere BVH, media bounded by a mesh). The reference
differs from the program's engines in how it walks the work, not in what
it computes: it takes any set of pixels, traces every sample of each as
one wavefront, and shades only the lanes still alive at each bounce.
Every random decision is a pure function of ``(seed, pixel, sample,
bounce, dimension)``, and every operation acts lane by lane, so a lane's
path is the program's path whichever lanes share its wavefront.

``planes`` names the float type the wavefront's throughput and radiance
are kept in between bounces: float32, as the configurations state, or
bfloat16, the precision control of :mod:`benchmark.check`.
"""
from __future__ import annotations

import torch

from benchmark.reference.core import (as_word, create_salt, dot, gsdiv,
                                      hash_combine, sobol_points, to_local,
                                      uniform, where3)
from benchmark.reference.media import apply_media
from benchmark.reference.shading import (bsdf_pdf, bsdf_weight, emitted,
                                         face_basis, is_scattering,
                                         is_specular, lights_pdf,
                                         sample_bsdf, sample_lights,
                                         scatter_specular)
from benchmark.reference.scene import SPECULAR_MATS
from benchmark.reference.spheres import intersect_scene

# sampler dimensions a bounce draws (srt_tpu_torch/render/integrator.py)
DIM_SPEC = 8          # the specular branch's four uniforms
DIM_MIX = 12          # light-vs-bsdf pick
DIM_LIGHT_PICK = 13
DIM_SAMPLE = 14       # u1, u2 for light point / bsdf lobe
DIM_RR = 16           # russian roulette
# ... and a primary ray (srt_tpu_torch/kernels/bounce.py, diff/inverse.py)
DIM_PIX_X = 30        # the train step's pixel jitter
DIM_PIX_Y = 31
DIM_LENS = 32
DIM_TIME = 34
#: the lanes traced at once; more pixels go in blocks of pixels
BLOCK_LANES = 1 << 18


def bounce(scene, state: dict, max_depth: int, rr_start: int,
           pdf_floor: float = 1e-9) -> dict:
    """One bounce of ``state`` (``o d beta radiance`` (N, 3), ``time``,
    ``salt`` 32-bit words, ``depth`` int32, ``alive`` bool): the closest
    hit, overridden by a nearer event in a medium, emission, the 50/50
    mixture of light and BSDF sampling with its mixture pdf, the specular
    branch, roulette from ``rr_start``. Returns the next state (``alive``
    not yet capped by depth)."""
    flags = scene.flags
    depth = state["depth"]
    salt = hash_combine(as_word(state["salt"]), as_word(depth))
    o, d = state["o"], state["d"]
    alive, beta = state["alive"], state["beta"]

    hit = intersect_scene(scene, o, d, 1e-3, state["time"])
    if scene.n_media:
        hit = apply_media(scene, o, d, salt, hit)
    # sanitize miss lanes: zero normal -> +z, far position -> origin
    up = torch.zeros_like(hit.normal)
    up[:, 2] = 1.0
    p = where3(hit.hit, hit.p, o)
    normal = where3(hit.hit & (dot(hit.normal, hit.normal) > 1e-12),
                    hit.normal, up)

    # emission, added whether or not the path continues
    emit = emitted(scene, hit.mat, hit.uv, p, normal, d, flags)
    radiance = state["radiance"] + torch.where((alive & hit.hit)[:, None],
                                               beta * emit, 0.0)
    scatters = hit.hit & is_scattering(scene, hit.mat)

    # diffuse branch: mixture-pdf NEE (Raytracing_n.cpp:71-94)
    basis = face_basis(normal, d)
    wo = to_local(basis, -d)
    u1 = uniform(salt, DIM_SAMPLE)
    u2 = uniform(salt, DIM_SAMPLE + 1)
    wi = sample_bsdf(scene, hit.mat, basis, wo, u1, u2, flags)
    if scene.n_lights:
        light_dir = sample_lights(
            scene, p, uniform(salt, DIM_LIGHT_PICK), u1, u2)
        wi = where3(uniform(salt, DIM_MIX) < 0.5, light_dir, wi)
    pdf = bsdf_pdf(scene, hit.mat, basis, wo, wi, flags)
    if scene.n_lights:
        pdf = 0.5 * lights_pdf(scene, p, wi) + 0.5 * pdf
    weight = bsdf_weight(scene, hit.mat, hit.uv, p, basis, wo, wi, flags)
    # below-floor pdfs contribute zero (the reference retries instead)
    diff_beta = torch.where((pdf > pdf_floor)[:, None],
                            gsdiv(weight,
                                  torch.clamp(pdf, min=pdf_floor)[:, None]),
                            0.0)

    # specular branch (Raytracing_n.cpp:66-70), on the stored normal
    if set(flags.mat_kinds) & SPECULAR_MATS:
        u_spec = [uniform(salt, DIM_SPEC + i) for i in range(4)]
        spec_dir, spec_att = scatter_specular(
            scene, hit.mat, hit.uv, p, normal, d, u_spec, flags)
        specular = scatters & is_specular(scene, hit.mat)
        wi = where3(specular, spec_dir, wi)
        diff_beta = where3(specular, spec_att, diff_beta)

    new_beta = beta * diff_beta
    beta_max = new_beta.max(-1).values
    new_alive = alive & scatters & (beta_max > 0.0)
    if rr_start < max_depth:
        q = torch.clamp(beta_max, 0.05, 1.0)
        survive = uniform(salt, DIM_RR) < q
        new_alive = new_alive & ((depth < rr_start) | survive)
        new_beta = torch.where((new_alive & (depth >= rr_start))[:, None],
                               new_beta / q[:, None], new_beta)

    upd = (alive & scatters)[:, None]
    return dict(o=torch.where(upd, p, o), d=torch.where(upd, wi, d),
                time=state["time"],
                beta=torch.where(alive[:, None], new_beta, beta),
                radiance=radiance, alive=new_alive & alive,
                salt=state["salt"], depth=depth + 1)


def trace(scene, rays, salt: torch.Tensor, *, max_depth: int,
          rr_start: int = 1 << 30, planes=torch.float32):
    """Radiance (N, 3) of primary rays ``(origin, direction, time)`` with
    salts, after ``max_depth`` bounces, NaN scrubbed (de_nan), and the
    live lanes entering each bounce (a list of ints). Each bounce shades
    only its live lanes and writes them back, out of place, so autograd
    follows the paths. ``planes``: see the module's docstring."""
    o, d, time = rays
    n, dev = o.shape[0], o.device
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    st = dict(o=o, d=d, time=time,
              beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
              salt=salt.to(torch.int32),
              depth=torch.zeros((n,), dtype=torch.int32, device=dev))
    idx = torch.arange(n, device=dev)
    live = []
    for _ in range(max_depth):
        if idx.numel() == 0:
            break
        live.append(int(idx.numel()))
        sub = {k: v[idx] for k, v in st.items()}
        sub["radiance"] = radiance[idx]
        sub["alive"] = torch.ones((idx.numel(),), dtype=torch.bool,
                                  device=dev)
        out = bounce(scene, sub, max_depth, rr_start)
        rad = out["radiance"]
        if planes != torch.float32:
            out["beta"] = out["beta"].to(planes).to(torch.float32)
            rad = rad.to(planes).to(torch.float32)
        radiance = radiance.index_copy(0, idx, rad)
        keep = out["alive"]
        idx = idx[keep]
        st = {k: st[k].index_copy(0, idx, out[k][keep])
              for k in ("o", "d", "beta", "depth")} | dict(
                  time=st["time"], salt=st["salt"])
    return torch.where(torch.isnan(radiance), 0.0, radiance), live


def pixel_jitter(spp: int, device) -> torch.Tensor:
    """The (spp, 2) Sobol pixel jitter the renders read by sample index
    (``srt_tpu_torch/render/api.py:pixel_jitter``)."""
    return torch.from_numpy(sobol_points(max(spp, 2), 2)[:max(spp, 1)]
                            .astype("float32")).to(device)


def render_rays(camera, pixel_ids: torch.Tensor, *, width: int, height: int,
                spp: int, seed: int):
    """Every sample of each pixel, pixel-major: the renders' primary rays
    (Sobol jitter, lens and time from the pixel's sample stream) and
    salts."""
    jitter = pixel_jitter(spp, pixel_ids.device)
    pix = pixel_ids.long().repeat_interleave(spp)
    samp = torch.arange(spp, device=pix.device).repeat(pixel_ids.shape[0])
    jit = jitter[samp]
    s = ((pix % width).to(torch.float32) + jit[:, 0]) / width
    t = ((height - 1.0 - (pix // width).to(torch.float32)) + jit[:, 1]) \
        / height
    salt = create_salt(seed, pix, samp)
    rays = camera.rays(s, t, uniform(salt, DIM_LENS),
                       uniform(salt, DIM_LENS + 1), uniform(salt, DIM_TIME))
    return rays, salt


def train_rays(camera, pixel_ids: torch.Tensor, *, width: int, height: int,
               spp: int, seed: int):
    """The train step's primary rays: pixel jitter from the sample stream
    (dimensions 30 and 31, ``srt_tpu_torch/diff/inverse.py:camera_rays``)."""
    pix = pixel_ids.long().repeat_interleave(spp)
    samp = torch.arange(spp, device=pix.device).repeat(pixel_ids.shape[0])
    salt = create_salt(int(seed), pix, samp)
    s = ((pix % width).to(torch.float32) + uniform(salt, DIM_PIX_X)) / width
    t = ((height - 1.0 - (pix // width).to(torch.float32))
         + uniform(salt, DIM_PIX_Y)) / height
    rays = camera.rays(s, t, uniform(salt, DIM_LENS),
                       uniform(salt, DIM_LENS + 1), uniform(salt, DIM_TIME))
    return rays, salt


def _blocks(n_pixels: int, spp: int, block_lanes: int):
    step = max(1, block_lanes // spp)
    return [(p0, min(p0 + step, n_pixels)) for p0 in range(0, n_pixels, step)]


def render_pixels(scene, camera, pixel_ids: torch.Tensor, *, width: int,
                  height: int, spp: int, max_depth: int, seed: int,
                  rr_start: int = 1 << 30, planes=torch.float32,
                  block_lanes: int = BLOCK_LANES):
    """The image's value (P, 3) at ``pixel_ids``: the mean of every sample
    of each pixel, and the live lanes entering each bounce summed over
    the blocks."""
    out, live = [], []
    with torch.no_grad():
        for p0, p1 in _blocks(pixel_ids.shape[0], spp, block_lanes):
            rays, salt = render_rays(camera, pixel_ids[p0:p1], width=width,
                                     height=height, spp=spp, seed=seed)
            rad, lv = trace(scene, rays, salt, max_depth=max_depth,
                            rr_start=rr_start, planes=planes)
            out.append(rad.reshape(p1 - p0, spp, 3).sum(1) / spp)
            live = [a + b for a, b in zip(live, lv)] + lv[len(live):]
    return torch.cat(out), live


def loss_and_grad(scene, camera, tex_color: torch.Tensor, target, *,
                  width: int, height: int, spp: int, max_depth: int,
                  seed: int, planes=torch.float32,
                  block_lanes: int = BLOCK_LANES):
    """The train step's L2 loss over every pixel, the mean of
    ``(image - target)**2`` with the image each pixel's mean over ``spp``
    samples, and its gradient with respect to ``tex_color``, summed over
    blocks of pixels; and the live lanes entering each bounce."""
    n = width * height
    pixel_ids = torch.arange(n, device=tex_color.device)
    leaf = tex_color.detach().clone().requires_grad_()
    scene.tex_color = leaf
    total = torch.zeros((), dtype=torch.float64, device=leaf.device)
    live = []
    try:
        for p0, p1 in _blocks(n, spp, block_lanes):
            rays, salt = train_rays(camera, pixel_ids[p0:p1], width=width,
                                    height=height, spp=spp, seed=seed)
            rad, lv = trace(scene, rays, salt, max_depth=max_depth,
                            planes=planes)
            img = rad.reshape(p1 - p0, spp, 3).mean(1)
            part = ((img - target[p0:p1]) ** 2).sum() / (3 * n)
            part.backward()
            total += part.detach().double()
            live = [a + b for a, b in zip(live, lv)] + lv[len(live):]
    finally:
        scene.tex_color = tex_color.detach()
    return float(total), leaf.grad.detach(), live


def adam_steps(scene, camera, tex_color: torch.Tensor, target, seeds, *,
               lr: float, width: int, height: int, spp: int, max_depth: int,
               planes=torch.float32, block_lanes: int = BLOCK_LANES):
    """Adam (b1 0.9, b2 0.999, eps 1e-8 added to the bias-corrected
    ``sqrt(v)``, ``optax.adam``'s form) over ``tex_color`` for one step a
    seed. Returns the loss of each step, the first step's gradient and
    the parameters after the last step."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = tex_color.detach().clone().float()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    losses, grad1 = [], None
    for k, seed in enumerate(seeds, start=1):
        loss, g, _ = loss_and_grad(
            scene, camera, p, target, width=width, height=height, spp=spp,
            max_depth=max_depth, seed=seed, planes=planes,
            block_lanes=block_lanes)
        losses.append(loss)
        if grad1 is None:
            grad1 = g.clone()
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        m_hat = m / (1.0 - b1 ** k)
        v_hat = v / (1.0 - b2 ** k)
        p = p - lr * m_hat / (torch.sqrt(v_hat) + eps)
    scene.tex_color = tex_color.detach()
    return dict(losses=losses, grad1=grad1, params=p)
