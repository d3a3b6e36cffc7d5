"""Top-level render API (counterpart of ``srt_tpu/render/api.py``): the
render configuration and the scan engine, pixels × samples -> image.

:func:`render` loops over sample chunks and, within each, over pixel
chunks (:func:`sample_chunks`, the loop :func:`utils.checkpoint.
render_resumable` shares); a chunk's pixels × samples are one wavefront,
traced by :func:`render.integrator.trace` over ``max_depth`` bounces in
lockstep, each bounce one step of the render's :class:`render.route.
Route` (kernel B2, after B3 or B4 on a triangle scene). The regeneration engine
(:func:`render.regen.render_regen`) traces the same estimator from the
same random streams.
"""
from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from srt_tpu_torch.core import rng
from srt_tpu_torch.core.sobol import sobol_points
from srt_tpu_torch.kernels.bounce import DIM_LENS, DIM_TIME, StepSpec
from srt_tpu_torch.render import film
from srt_tpu_torch.render.integrator import trace
from srt_tpu_torch.render.route import Route
from srt_tpu_torch.scene.ir import SceneFlags, require_covered
from srt_tpu_torch.utils.metrics import RenderMetrics


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """A copy of the JAX package's ``RenderConfig``, field for field, so a
    configuration written for one package runs in the other, and one
    field of the port's own after them (:data:`PORT_CONFIG`). Both engines
    read ``width height spp max_depth seed rr_start sobol_pixel_jitter
    pdf_floor ref_parity parity_no_stale sphere_bvh`` (the estimator
    switches and the sphere BVH's through :func:`scene_flags`); the
    regeneration engine reads ``wavefront``, the scan engine
    (:func:`render`) ``sample_chunk``, ``pixel_chunk`` and ``seq_stale``.
    ``sphere_bvh`` walks the scene's sphere BVH in the plain bounce, which
    the JAX package turns on with its environment variable
    ``SRT_TPU_SPHERE_BVH=on``; the port reads no environment variable for
    it."""
    width: int = 256
    height: int = 256
    spp: int = 64
    max_depth: int = 16
    seed: int = 0
    rr_start: int = 1 << 30          # roulette off (reference parity)
    sample_chunk: int = 8            # scan engine
    pixel_chunk: int = 1 << 16       # scan engine
    sobol_pixel_jitter: bool = True  # Raytracing_n.cpp:834-835
    pdf_floor: float = 1e-9          # zero-contribution mixture-pdf cutoff
    ref_parity: bool = False         # as-implemented reference estimator
    wavefront: int = 1 << 16         # persistent-wavefront lanes (regen)
    parity_no_stale: bool = False    # parity diagnostic: the slot reads 0
    seq_stale: bool = False          # parity scan-engine mode
    sphere_bvh: bool = False         # the plain bounce walks the sphere BVH


#: the fields of :class:`RenderConfig` that the JAX package's has not
PORT_CONFIG = ("sphere_bvh",)


def scene_flags(scene, config) -> SceneFlags:
    """The scene's flags with the config's estimator switches
    (``srt_tpu/render/api.py:61-71``), ``ref_parity`` and
    ``parity_no_stale``, and its ``sphere_bvh``."""
    return SceneFlags.of(scene)._replace(
        ref_parity=bool(getattr(config, "ref_parity", False)),
        parity_no_stale=bool(getattr(config, "parity_no_stale", False)),
        sphere_bvh=bool(getattr(config, "sphere_bvh", False)))


def _rng_jitter(spp: int, seed: int) -> torch.Tensor:
    """Pixel jitter from the sampler stream (``sobol_pixel_jitter=False``)."""
    s = torch.arange(spp, dtype=torch.int64)
    return torch.stack([
        rng.bits_to_uniform(rng.hash_combine(s, (seed * 2 + k) & rng.MASK32))
        for k in (101, 102)], -1)


def pixel_jitter(config) -> torch.Tensor:
    """The (spp, 2) pixel jitter both engines read by sample index: Sobol
    points, or the sampler stream's (``api.py:140-145``)."""
    spp = config.spp
    if config.sobol_pixel_jitter:
        return torch.from_numpy(
            sobol_points(max(spp, 2), 2)[:max(spp, 1)].astype(np.float32))
    return _rng_jitter(spp, config.seed)


def chunk_rays(camera, pixel_ids: torch.Tensor, sample0: int,
               jitter: torch.Tensor, seed: int, *, width: int, height: int,
               n_samples: int):
    """The primary rays of a chunk, pixel-major with ``n_samples``
    consecutive samples from ``sample0`` each (``api.py:95-112``):
    ``((origin, direction, time), salt)``, the salt as 32-bit words."""
    p = pixel_ids.shape[0]
    pix = pixel_ids.repeat_interleave(n_samples)
    samp = sample0 + torch.arange(n_samples,
                                  device=pixel_ids.device).repeat(p)
    col = (pix % width).to(torch.float32)
    row = (pix // width).to(torch.float32)
    jit = jitter[samp % jitter.shape[0]]
    s = (col + jit[:, 0]) / width
    t = ((height - 1.0 - row) + jit[:, 1]) / height
    salt = rng.create_salt(seed, pix, samp)
    rays = camera.rays(s, t, rng.uniform(salt, DIM_LENS),
                       rng.uniform(salt, DIM_LENS + 1),
                       rng.uniform(salt, DIM_TIME))
    return rays, salt


def _render_chunk(route: Route, camera, pixel_ids: torch.Tensor,
                  sample0: int, jitter: torch.Tensor, seed: int, *,
                  width: int, height: int, n_samples: int,
                  with_aux: bool = False, stale_in=None):
    """Radiance sum over ``n_samples`` consecutive samples from ``sample0``
    for a chunk of pixels (``api.py:82-124``): (P, 3), the chunk's pixels ×
    samples traced as one wavefront. With ``stale_in`` (``n_samples`` 1:
    lane = pixel) the parity heap-slot plane threads through and back out
    -> ``(radiance, stale)``; with ``with_aux`` -> ``(radiance, aux)``."""
    p = pixel_ids.shape[0]
    rays, salt = chunk_rays(camera, pixel_ids, sample0, jitter, seed,
                            width=width, height=height, n_samples=n_samples)
    parity = route.flags.ref_parity
    if stale_in is not None:
        if n_samples != 1:
            raise ValueError("threading the stale plane needs lane = pixel")
        return trace(route, rays, salt, max_depth=route.spec.max_depth,
                     parity=parity, stale0=stale_in, return_stale=True)
    out = trace(route, rays, salt, max_depth=route.spec.max_depth,
                parity=parity, with_aux=with_aux)
    if with_aux:
        radiance, aux = out
        return radiance.reshape(p, n_samples, 3).sum(1), aux
    return out.reshape(p, n_samples, 3).sum(1)


def render_setup(scene, config, plain: bool = False) -> tuple:
    """What a render of ``scene`` under ``config`` runs with, on the
    scene's device: its flags (:func:`scene_flags`; a scene outside the
    port's coverage raises), the pixel jitter (:func:`pixel_jitter`) and
    the bounce :class:`Route`. ``plain=True`` takes the kernels' plain
    versions on any device."""
    flags = scene_flags(scene, config)
    require_covered(scene, flags)
    route = Route(scene, flags, StepSpec(max_depth=config.max_depth,
                                         rr_start=config.rr_start,
                                         pdf_floor=config.pdf_floor), plain)
    return flags, pixel_jitter(config).to(scene.device), route


def sample_chunks(route: Route, camera, config, jitter: torch.Tensor,
                  s_start: int = 0, seq: bool = False,
                  with_aux: bool = False, pixels: tuple | None = None):
    """The scan engine's loop from sample ``s_start``: for each chunk of
    ``sample_chunk`` samples, every pixel chunk in turn, yields
    ``(s_end, part, aux)``: the samples done after it, its radiance sums
    (pixels, 3) and, under ``with_aux``, its counters summed over the
    pixel chunks (else None). Under ``seq`` a chunk is one sample (lane =
    pixel) and each pixel's heap-slot plane carries over from sample to
    sample. ``pixels``: the pixel ids ``[lo, hi)`` to trace (a rank's
    strip, :func:`dist.sharding.render_sharded`), by default the image."""
    w, h, spp = config.width, config.height, config.spp
    lo, hi = pixels if pixels is not None else (0, w * h)
    dev = jitter.device
    chunk = 1 if seq else min(config.sample_chunk, spp)
    stale = (torch.zeros((hi - lo,), dtype=torch.float32, device=dev)
             if seq else None)
    s0 = s_start
    while s0 < spp:
        n_s = min(chunk, spp - s0)
        parts, aux = [], None
        for p0 in range(lo, hi, config.pixel_chunk):
            p1 = min(p0 + config.pixel_chunk, hi)
            out = _render_chunk(
                route, camera, torch.arange(p0, p1, device=dev), s0, jitter,
                config.seed, width=w, height=h, n_samples=n_s,
                with_aux=with_aux,
                stale_in=None if stale is None else stale[p0 - lo:p1 - lo])
            if seq:
                out, stale[p0 - lo:p1 - lo] = out
            elif with_aux:
                out, a = out
                aux = a if aux is None else {k: aux[k] + a[k] for k in a}
            parts.append(out)
        s0 += n_s
        yield s0, torch.cat(parts), aux


def sequential(config, flags) -> bool:
    """Whether the scan engine traces each pixel's samples one at a time,
    the heap-slot plane carried from sample to sample: ``seq_stale``
    under ``ref_parity`` (``api.py:160``)."""
    return bool(config.seq_stale and flags.ref_parity)


def accumulate(route: Route, camera, config, jitter: torch.Tensor, *,
               seq: bool | None = None, s_start: int = 0, acc=None,
               pixels: tuple | None = None, with_aux: bool = False,
               on_chunk=None) -> tuple:
    """The radiance sums of the image, or of the pixel ids ``pixels =
    [lo, hi)``: each chunk of :func:`sample_chunks` from sample
    ``s_start`` added in its order onto ``acc`` (zeros by default), with
    no atomics. :func:`render`, :func:`utils.checkpoint.render_resumable`
    and :func:`dist.sharding.render_sharded` all sum here, so they agree
    to the bit. ``seq`` defaults to :func:`sequential`. ``on_chunk(s_end,
    acc)`` runs after each chunk. Returns ``(acc, aux)``: the (pixels, 3)
    sums and, under ``with_aux`` (not with ``seq``), the counters summed
    over the chunks, else None."""
    if seq is None:
        seq = sequential(config, route.flags)
    lo, hi = pixels if pixels is not None else (0,
                                                config.width * config.height)
    if acc is None:
        acc = torch.zeros((hi - lo, 3), dtype=torch.float32,
                          device=jitter.device)
    aux_sum = None
    with torch.no_grad():
        for s0, part, aux in sample_chunks(route, camera, config, jitter,
                                           s_start, seq=seq,
                                           with_aux=with_aux and not seq,
                                           pixels=pixels):
            acc = acc + part
            if aux is not None:
                aux_sum = (aux if aux_sum is None else
                           {k: aux_sum[k] + aux[k] for k in aux})
            if on_chunk is not None:
                on_chunk(s0, acc)
    return acc, aux_sum


def render(scene, camera, config: RenderConfig, metrics: bool = False,
           plain: bool = False):
    """Render a linear-radiance image (H, W, 3) float32 with the scan
    engine, on the scene's device (``api.py:127-187``): the sums of
    :func:`accumulate` over ``spp``, so a resumed or sharded render equals
    this one to the bit. Under :func:`sequential` each pixel's samples go
    one at a time (lane = pixel), the heap-slot plane carried from sample
    to sample.

    ``metrics=True`` also returns a :class:`RenderMetrics` (bounce
    histogram, path vertices, NaN scrubs, the route). ``plain=True`` runs
    the kernels' plain versions on any device."""
    _, jitter, route = render_setup(scene, config, plain)
    w, h, spp = config.width, config.height, config.spp
    dev = scene.device
    t0 = _time.time()
    acc, aux_sum = accumulate(route, camera, config, jitter,
                              with_aux=metrics)
    img = (acc / spp).reshape(h, w, 3)
    if not metrics:
        return img
    m = RenderMetrics(width=w, height=h, spp=spp, max_depth=config.max_depth,
                      primary_rays=w * h * spp, bounces=route.steps,
                      bounce=route.bounce, walk=route.walk)
    if aux_sum is not None:
        m.alive_per_bounce = aux_sum["alive_per_bounce"].cpu().numpy()
        m.path_vertices = int(aux_sum["path_vertices"])
        m.nan_scrubbed = int(aux_sum["nan_scrubbed"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    m.wall_s = _time.time() - t0
    return img, m


def render_tonemapped(scene, camera, config: RenderConfig, **kw):
    """:func:`render`, sqrt gamma and clamped to [0, 1] (``api.py:202``)."""
    return film.tonemap(render(scene, camera, config, **kw))
