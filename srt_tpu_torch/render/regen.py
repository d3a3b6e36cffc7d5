"""Path-regeneration render engine: a persistent full wavefront
(counterpart of ``srt_tpu/render/regen.py``).

Two loops, chosen by the scene as ``fused_regen_available`` chooses
(``srt_tpu/pallas/bounce.py:1605-1618``):

* without triangles, one launch of
  :func:`srt_tpu_torch.kernels.bounce.regen_bounce` (kernel B1) is one
  bounce of the whole wavefront plus the regeneration of its dead lanes
  from the ``(pixel, sample)`` work queue; the scene's families pick its
  instantiation (``RegenInputs.rich``: lean for ball_scenes, rich for the
  specular branch, media, checker and noise textures, image albedo and
  sphere lights);
* with triangles (``regen.py:135-255``), each bounce regenerates the dead
  lanes in torch (:func:`kernels.bounce.regenerate`), finds each lane's
  closest triangle with the walk the JAX package's rule picks once a
  render (:func:`render.intersect.two_level`: kernel B4, the two-level
  walk, for a mesh beyond the single-level budget such as
  ``teapot_scene``'s, else kernel B3) and runs the bounce with kernel B2
  in its external-hit mode (:func:`kernels.bounce.bounce_fwd`, lean or
  rich as above), then applies the depth cap.

The host loop adds the finished lanes' radiance into the image,
NaN-scrubbed and counted. Every random decision is a pure function of
``(seed, pixel, sample, bounce)``, so the image equals the JAX engine's up
to float accumulation order and near-tie branch flips.

The host reads the device (work cursor, any lane alive) once every
``CHECK_EVERY`` bounces: a bounce of a drained, all-dead wavefront takes
no lane and finishes none, so the extra bounces change nothing.
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch

from srt_tpu_torch.core import rng
from srt_tpu_torch.core.sobol import sobol_points
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.render.intersect import (intersect_tris,
                                            intersect_tris_big, two_level)
from srt_tpu_torch.scene.ir import SceneFlags, require_covered
from srt_tpu_torch.utils.metrics import RenderMetrics

CHECK_EVERY = 8


def _rng_jitter(spp: int, seed: int) -> torch.Tensor:
    """Pixel jitter from the sampler stream (``sobol_pixel_jitter=False``)."""
    s = torch.arange(spp, dtype=torch.int64)
    return torch.stack([
        rng.bits_to_uniform(rng.hash_combine(s, (seed * 2 + k) & rng.MASK32))
        for k in (101, 102)], -1)


class _Film:
    """The image sums (3, pixels) and the counters, on the device."""

    def __init__(self, pixels: int, device):
        self.acc = torch.zeros((3, pixels), dtype=torch.float32,
                               device=device)
        self.n_vertices = torch.zeros((), dtype=torch.int64, device=device)
        self.nan_scrubbed = torch.zeros((), dtype=torch.int64, device=device)

    def flush(self, pix, fin, radiance, live) -> None:
        """Add the finished lanes' radiance (3, N) at their pixels, NaN
        scrubbed and counted (de_nan, ``Raytracing_n.cpp:47-53``); count
        the bounce's ``live`` lanes as traced path vertices."""
        contrib = torch.where(fin, radiance, 0.0)
        is_nan = torch.isnan(contrib)
        self.acc.index_add_(1, pix, torch.where(is_nan, 0.0, contrib))
        self.n_vertices += live.sum()
        self.nan_scrubbed += is_nan.sum()


def _regen_loop(inp: kb.RegenInputs, spec: kb.RegenSpec, n: int,
                film: _Film, plain: bool) -> int:
    """The B1 loop; returns its bounces."""
    step = kb.regen_bounce_reference if plain else kb.regen_bounce
    st = kb.new_wavefront(n, inp.scene.device)
    bounces = 0
    while True:
        for _ in range(CHECK_EVERY):
            step(inp, st, spec)
            fin = st["fin"] != 0
            film.flush(st["pix"], fin, st["radiance"],
                       (st["alive"] != 0) | fin)
        bounces += CHECK_EVERY
        cursor, any_alive = torch.stack(
            [st["cursor"][0].long(), (st["alive"] != 0).any().long()]).tolist()
        if cursor >= spec.total_work and not any_alive:
            return bounces


def _tri_loop(inp: kb.RegenInputs, spec: kb.RegenSpec, n: int,
              film: _Film, plain: bool) -> int:
    """The loop for triangle scenes, B4 or B3 then B2 per bounce; returns
    its bounces."""
    scene, flags, tables = inp.scene, inp.flags, inp.tables
    dev = scene.device
    step = kb.StepSpec(max_depth=spec.max_depth, rr_start=spec.rr_start,
                       pdf_floor=spec.pdf_floor)
    if plain:
        walk = intersect_tris_big if two_level(scene) else intersect_tris

        def hits(o, d):
            return walk(scene, o, d, leaf_size=flags.bvh_leaf)

        def bounce(state, tri):
            return kb.bounce_step_ref(scene, flags, tables["mat"], state,
                                      step, tri)
    else:
        packed = ki.pack_walk(scene)

        def hits(o, d):
            return ki.closest_tris(scene, packed, o, d)

        def bounce(state, tri):
            return kb.bounce_fwd(scene, flags, tables, state, step, tri)

    z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    st = dict(o=z3, d=z3 + torch.tensor([0.0, 0.0, 1.0], device=dev),
              time=torch.zeros((n,), device=dev), beta=z3, radiance=z3,
              salt=zi, depth=zi, alive=torch.zeros((n,), dtype=torch.bool,
                                                   device=dev),
              pix=zi.long())
    cursor = torch.zeros((), dtype=torch.int64, device=dev)
    bounces = 0
    while True:
        for _ in range(CHECK_EVERY):
            state, take, pix = kb.regenerate(inp, spec, st, cursor)
            cursor = cursor + take.sum()
            state["salt"] = state["salt"].to(torch.int32)  # the bit pattern
            nxt = bounce(state, hits(state["o"], state["d"]))
            alive = nxt["alive"] & (nxt["depth"] < spec.max_depth)
            film.flush(pix, state["alive"] & ~alive, nxt["radiance"].T,
                       state["alive"])
            st = dict(nxt, alive=alive, pix=pix)
        bounces += CHECK_EVERY
        left, any_alive = torch.stack(
            [cursor, st["alive"].any().long()]).tolist()
        if left >= spec.total_work and not any_alive:
            return bounces


def render_regen(scene, camera, config, metrics: bool = False,
                 plain: bool = False):
    """Render a linear-radiance image (H, W, 3) float32 on the scene's
    device. Raises ``NotImplementedError`` for a scene outside the port's
    coverage. ``plain=True`` runs the kernels' plain versions on any
    device, which is how the kernels' image is checked on the card."""
    flags = SceneFlags.of(scene)
    require_covered(scene, flags, getattr(config, "ref_parity", False))
    w, h, spp = config.width, config.height, config.spp
    if config.sobol_pixel_jitter:
        jitter = torch.from_numpy(
            sobol_points(max(spp, 2), 2)[:max(spp, 1)].astype(np.float32))
    else:
        jitter = _rng_jitter(spp, config.seed)
    spec = kb.RegenSpec(width=w, height=h, spp=spp,
                        max_depth=config.max_depth, rr_start=config.rr_start,
                        pdf_floor=config.pdf_floor, seed=config.seed)
    inp = kb.RegenInputs(scene, flags, camera, jitter)
    film = _Film(w * h, scene.device)
    loop = _tri_loop if scene.n_tris else _regen_loop
    t0 = _time.time()
    with torch.no_grad():
        bounces = loop(inp, spec, min(config.wavefront, spec.total_work),
                       film, plain)
    img = (film.acc / spp).T.reshape(h, w, 3)
    if not metrics:
        return img
    m = RenderMetrics(width=w, height=h, spp=spp, max_depth=config.max_depth,
                      primary_rays=w * h * spp,
                      path_vertices=int(film.n_vertices),
                      nan_scrubbed=int(film.nan_scrubbed), bounces=bounces,
                      wall_s=_time.time() - t0)
    return img, m
