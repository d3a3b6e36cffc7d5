"""Path-regeneration render engine: a persistent full wavefront
(counterpart of ``srt_tpu/render/regen.py``).

Two loops, chosen by the scene and the estimator as
``fused_regen_available`` chooses (``srt_tpu/pallas/bounce.py:1605-1618``):

* without triangles and parity, on a scene the bounce kernels' gate admits
  (``SceneFlags.fused_bounce``, :mod:`render.route`), one launch of
  :func:`srt_tpu_torch.kernels.bounce.regen_bounce` (kernel B1) is one
  bounce of the whole wavefront plus the regeneration of its dead lanes
  from the ``(pixel, sample)`` work queue; the scene's families pick its
  instantiation (``RegenInputs.rich``: lean for ball_scenes, rich for the
  specular branch, media, checker and noise textures, image albedo and
  sphere lights);
* otherwise (triangles, the reference-parity estimator, or a scene the
  gate refuses: mesh-bounded media, more spheres, rects, lights,
  materials or media than the kernels' tables hold) the per-bounce loop
  (``regen.py:135-255``): each bounce regenerates the dead lanes in torch
  (:func:`kernels.bounce.regenerate`) and takes one step of the render's
  :class:`render.route.Route`: on a triangle scene each lane's closest
  triangle from the walk the JAX package's rule picks once a render
  (:func:`render.intersect.two_level`: kernel B4, the two-level walk, for
  a mesh beyond the single-level budget such as ``teapot_scene``'s, else
  kernel B3), then the bounce: kernel B2 (:func:`kernels.bounce.
  bounce_fwd`: lean or rich as above, with the external hit on a triangle
  scene, ``kParity`` under parity) where the gate admits the scene, the
  plain bounce where it does not; then the depth cap. Under parity the
  loop carries the ``stale`` plane across regeneration, as
  ``srt_tpu/render/regen.py:173-177`` does; the bounce does not read it.

The host loop adds the finished lanes' radiance into the image,
NaN-scrubbed and counted. Every random decision is a pure function of
``(seed, pixel, sample, bounce)``, so the image equals the JAX engine's up
to float accumulation order and near-tie branch flips, and equals the scan
engine's (:func:`render.api.render`) likewise.

The host reads the device (work cursor, any lane alive) once every
``CHECK_EVERY`` bounces: a bounce of a drained, all-dead wavefront takes
no lane and finishes none, so the extra bounces change nothing.
"""
from __future__ import annotations

import time as _time

import torch

from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.render.api import render_setup
from srt_tpu_torch.render.integrator import CHECK_EVERY
from srt_tpu_torch.render.route import Route
from srt_tpu_torch.utils.metrics import RenderMetrics


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


def _step_loop(inp: kb.RegenInputs, spec: kb.RegenSpec, n: int,
               film: _Film, route: Route) -> int:
    """The per-bounce loop: the torch regeneration, then one step of
    ``route`` (the walk on a triangle scene, the bounce); returns its
    bounces."""
    dev = inp.scene.device
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    st = dict(o=z3, d=z3 + torch.tensor([0.0, 0.0, 1.0], device=dev),
              time=torch.zeros((n,), device=dev), beta=z3, radiance=z3,
              salt=zi, depth=zi, alive=torch.zeros((n,), dtype=torch.bool,
                                                   device=dev),
              pix=zi.long())
    if inp.flags.ref_parity:
        st["stale"] = torch.zeros((n,), device=dev)
    cursor = torch.zeros((), dtype=torch.int64, device=dev)
    bounces = 0
    while True:
        for _ in range(CHECK_EVERY):
            state, take, pix = kb.regenerate(inp, spec, st, cursor)
            cursor = cursor + take.sum()
            state["salt"] = state["salt"].to(torch.int32)  # the bit pattern
            if inp.flags.ref_parity:
                state["stale"] = st["stale"]   # across regeneration
            nxt = route(state)
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
    device. Raises ``NotImplementedError`` for a scene or a config outside
    the port's coverage. ``config.ref_parity`` renders the reference's
    as-implemented estimator (``parity_no_stale`` its diagnostic variant).
    ``plain=True`` runs the kernels' plain versions on any device, which
    is how the kernels' image is checked on the card. The metrics name the
    route: the bounce ``"B1"``, ``"B2"`` or ``"plain"`` and the walk."""
    flags, jitter, route = render_setup(scene, config, plain)
    w, h, spp = config.width, config.height, config.spp
    spec = kb.RegenSpec(width=w, height=h, spp=spp,
                        max_depth=config.max_depth, rr_start=config.rr_start,
                        pdf_floor=config.pdf_floor, seed=config.seed)
    inp = kb.RegenInputs(scene, flags, camera, jitter)
    film = _Film(w * h, scene.device)
    n = min(config.wavefront, spec.total_work)
    t0 = _time.time()
    with torch.no_grad():
        if (scene.n_tris or flags.ref_parity
                or not flags.fused_bounce):
            bounces = _step_loop(inp, spec, n, film, route)
            names = dict(bounce=route.bounce, walk=route.walk)
        else:
            bounces = _regen_loop(inp, spec, n, film, plain)
            names = dict(bounce="plain" if plain else "B1", walk=None)
    img = (film.acc / spp).T.reshape(h, w, 3)
    if not metrics:
        return img
    m = RenderMetrics(width=w, height=h, spp=spp, max_depth=config.max_depth,
                      primary_rays=w * h * spp,
                      path_vertices=int(film.n_vertices),
                      nan_scrubbed=int(film.nan_scrubbed), bounces=bounces,
                      wall_s=_time.time() - t0, **names)
    return img, m
