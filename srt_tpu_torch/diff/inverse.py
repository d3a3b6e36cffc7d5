"""Differentiable rendering and inverse-rendering optimisation
(counterpart of ``srt_tpu/diff/inverse.py``).

Gradients of an image loss with respect to scene parameters -- material
parameters (Beckmann roughness, Oren-Nayar A/B), texture colours (albedo,
emission) and geometry (sphere centres and radii, rect planes such as a
light's height) -- straight through the wavefront estimator: the
regeneration engine :mod:`srt_tpu_torch.render.regen_scan` or the
lockstep scan engine (:func:`render.integrator.trace`, ``engine="scan"``),
whose bounce is kernel B2 forward and, on the card, kernel B5 backward
under frozen geometry -- its lean instantiation, or its rich one on the
specular branch, media, checker, noise and image textures and sphere
lights -- or the hybrid backward (the plain bounce replayed under autograd with kernel
B6's sphere winner) for geometry, the float image atlas and the scenes B5
does not cover (triangles, moving spheres), as the JAX package's gate
sends them; a scene that gate keeps off the bounce kernel (MERL,
mesh-bounded media, past its table caps) differentiates the plain bounce
under autograd. Random decisions are pure functions of ``(seed, pixel,
sample, bounce, dimension)``; the gradient follows the JAX package's
backward kernel, through the sampled direction and the pdfs (ROADMAP
C2). With a ``mesh`` (:mod:`srt_tpu_torch.dist`) each process takes the
loss and gradient of its strip of pixels and the ranks average both
before Adam, as the JAX step's ``shard_map`` and ``pmean`` do. The train
step never sets the parity estimator, as JAX's does not.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from srt_tpu_torch.core import rng
from srt_tpu_torch.dist import sharding
from srt_tpu_torch.kernels.bounce import (DIM_LENS, DIM_TIME, StepSpec,
                                          build_tables)
from srt_tpu_torch.kernels.bounce_vjp import bounce_step_auto
from srt_tpu_torch.kernels.intersect import pack_walk
from srt_tpu_torch.render.camera import Camera
from srt_tpu_torch.render.integrator import trace
from srt_tpu_torch.render.intersect import SPHERE_GEOM_FIELDS
from srt_tpu_torch.render.regen_scan import steps_for, trace_queue
from srt_tpu_torch.scene.ir import (CENTRE_FIELDS, SceneFlags, TorchScene,
                                    require_trainable)

DIM_PIX_X = 30                   # pixel-jitter sampler dimensions
DIM_PIX_Y = 31


def splice(scene: TorchScene, params: dict) -> TorchScene:
    """Replace scene fields by name from a parameter dict (e.g.
    ``{"tex_color": ..., "sph_center0": ...}``). Optimising the float
    ``atlas`` drops its packed rgb8 twin, as ``inverse.py:44-47`` does:
    gradients cannot flow through the integer gather, so every lookup
    reads the float atlas."""
    unknown = sorted(set(params) - {f.name for f in
                                    dataclasses.fields(TorchScene)})
    if unknown:
        raise KeyError(f"not scene fields: {unknown}")
    if "atlas" in params:
        return dataclasses.replace(scene, **params, atlas_u32=None)
    return dataclasses.replace(scene, **params)


def scene_to(scene: TorchScene, device) -> TorchScene:
    return dataclasses.replace(scene, **{
        f.name: getattr(scene, f.name).to(device)
        for f in dataclasses.fields(TorchScene)
        if getattr(scene, f.name) is not None})


def camera_to(camera: Camera, device) -> Camera:
    return Camera(*(t.to(device) for t in camera))


def render_pixels(scene: TorchScene, camera: Camera, pixel_ids, *,
                  width: int, height: int, spp: int, max_depth: int, seed,
                  engine: str = "regen", wavefront: int = 1 << 13,
                  depth_budget: float = 4.0, drain: int | None = 12,
                  flags: SceneFlags | None = None) -> torch.Tensor:
    """Mean radiance per pixel (P, 3), differentiable in the scene's
    material parameters, texture colours and geometric tensors, whichever
    require a gradient (the bounce takes kernel B5's backward when no
    geometric tensor does, ``bounce_vjp.bounce_step_auto``). Pixel
    jitter, lens and time samples come from the counter RNG (dimensions
    30-34), as ``inverse.py:97-111`` draws them. ``engine="regen"``
    traces the rays through the regeneration scan (``wavefront``,
    ``depth_budget`` and ``drain`` size it), ``engine="scan"`` all at once
    through ``max_depth`` lockstep bounces (``inverse.py:128-130``), which
    keeps every bounce's state for the backward. Runs on the scene's
    device."""
    if engine not in ("regen", "scan"):
        raise ValueError(f"engine {engine!r}: 'regen' or 'scan'")
    flags = flags if flags is not None else SceneFlags.of(scene)
    require_trainable(scene, flags)
    pixel_ids = torch.as_tensor(pixel_ids, device=scene.device).long()
    p = pixel_ids.shape[0]
    rays, salt = camera_rays(camera, pixel_ids, spp, width=width,
                             height=height, seed=seed)
    spec = StepSpec(max_depth=max_depth)
    tables = build_tables(scene, flags)
    if engine == "scan":
        walk = pack_walk(scene) if scene.n_tris else None
        radiance = trace(
            lambda st: bounce_step_auto(scene, flags, tables, st, spec, walk),
            rays, salt, max_depth=max_depth)
        return radiance.reshape(p, spp, 3).mean(1)
    steps = steps_for(p * spp, wavefront, depth_budget, max_depth,
                      drain=drain)
    radiance, _ = trace_queue(scene, flags, tables, rays, salt,
                              n_steps=steps, wavefront=wavefront, spec=spec)
    return radiance.reshape(p, spp, 3).mean(1)


def camera_rays(camera: Camera, pixel_ids: torch.Tensor, spp: int, *,
                width: int, height: int, seed):
    """The primary rays of :func:`render_pixels`, pixel-major with ``spp``
    samples each: ``((origin, direction, time), salt (P*spp,) int32)``."""
    pix = pixel_ids.long().repeat_interleave(spp)
    samp = torch.arange(spp, device=pix.device).repeat(pixel_ids.shape[0])
    salt = rng.create_salt(int(seed), pix, samp)
    col = (pix % width).to(torch.float32)
    row = (pix // width).to(torch.float32)
    s = (col + rng.uniform(salt, DIM_PIX_X)) / width
    t = ((height - 1.0 - row) + rng.uniform(salt, DIM_PIX_Y)) / height
    rays = camera.rays(s, t, rng.uniform(salt, DIM_LENS),
                       rng.uniform(salt, DIM_LENS + 1),
                       rng.uniform(salt, DIM_TIME))
    return rays, salt.to(torch.int32)      # int32 keeps the bit pattern


def image_loss(params: dict, scene: TorchScene, camera: Camera, target,
               pixel_ids, *, width: int, height: int, spp: int,
               max_depth: int, seed, engine: str = "regen",
               engine_kw: dict | None = None,
               flags: SceneFlags | None = None) -> torch.Tensor:
    """L2 loss between the rendered pixels and ``target`` (P, 3). The
    geometry is frozen exactly when no parameter is geometric, as
    ``inverse.py:150-151`` freezes it: a spliced parameter is the only
    scene tensor that requires a gradient."""
    img = render_pixels(splice(scene, params), camera, pixel_ids,
                        width=width, height=height, spp=spp,
                        max_depth=max_depth, seed=seed, engine=engine,
                        flags=flags, **(engine_kw or {}))
    return torch.mean((img - target) ** 2)


def adam(params, lr: float = 1e-2) -> torch.optim.Adam:
    """``torch.optim.Adam`` with ``optax.adam``'s defaults (b1 0.9, b2
    0.999, eps 1e-8 added to the bias-corrected ``sqrt(v)``): the same
    update up to rounding."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class TrainStep:
    """One Adam step of an image loss per call: ``step(target, seed) ->
    loss``. ``params`` holds the optimised tensors (leaves on the step's
    device); ``optimizer`` their ``torch.optim.Adam``; ``loss_fn(params,
    target (P, 3), seed)`` the differentiable loss; ``flags`` the scene
    flags its bounces run with."""

    def __init__(self, scene: TorchScene, camera: Camera, params: dict,
                 loss_fn: Callable, lr: float, device, flags: SceneFlags,
                 mesh=None, pixels: tuple | None = None):
        self.scene, self.camera, self.flags = scene, camera, flags
        self.mesh, self.pixels = mesh, pixels
        self.params = {k: torch.as_tensor(v, dtype=torch.float32)
                       .to(device).clone().requires_grad_()
                       for k, v in params.items()}
        if mesh is not None:            # rank 0's parameters start all
            with torch.no_grad():
                for v in self.params.values():
                    v.copy_(sharding.broadcast(mesh, v))
        self.optimizer = adam(list(self.params.values()), lr)
        self.loss_fn = loss_fn
        self.device = device

    def target(self, target) -> torch.Tensor:
        """``target`` as the (P, 3) float32 tensor the loss compares: the
        whole image's, or under a mesh this rank's strip of it."""
        t = torch.as_tensor(target, dtype=torch.float32,
                            device=self.device).reshape(-1, 3)
        return t if self.pixels is None else t[self.pixels[0]:
                                                self.pixels[1]]

    def __call__(self, target, seed) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.params, self.target(target), seed)
        loss.backward()
        if self.mesh is not None:       # pmean of the loss and gradients
            loss = sharding.pmean(self.mesh, loss.detach())
            for v in self.params.values():
                v.grad = sharding.pmean(self.mesh, v.grad)
        self.optimizer.step()
        return loss.detach()


def make_train_step(scene: TorchScene, camera: Camera, params: dict, *,
                    width: int, height: int, spp: int, max_depth: int,
                    lr: float = 1e-2, engine: str = "regen",
                    engine_kw: dict | None = None, mesh=None,
                    device=None, sphere_bvh: bool = False) -> TrainStep:
    """An Adam step ``(target, seed) -> loss`` of :func:`image_loss` over
    every pixel (counterpart of ``inverse.py:160-210``; ``optax.adam``
    becomes :func:`adam`). The scene, camera and parameters move to
    ``device`` (``cuda`` unless named); the step updates
    ``TrainStep.params`` in place. With a ``mesh``
    (:func:`dist.make_mesh`) the pixel count must divide over its ranks,
    as JAX's does: each rank renders its contiguous strip of pixels on
    the mesh's device (a ``device`` named besides must name it, else the
    step raises), rank 0's scene, camera and parameters start every rank,
    and the loss and gradients are averaged over the ranks before Adam
    (``inverse.py:192-200``), so every rank holds the same parameters. A
    sphere-centre parameter
    makes the spheres moving for the forward kernel, as the JAX package's
    flags degrade (``ir.py:115-125``): an optimised ``sph_center0`` leaves
    ``sph_center1`` where it was, so after the first step the sphere
    moves over the shutter interval. ``sphere_bvh`` walks the scene's
    sphere BVH where the plain bounce runs (``RenderConfig.sphere_bvh``);
    with a sphere geometry parameter it raises ``ValueError``, since the
    tree would keep the spheres' starting boxes
    (:func:`render.intersect.require_fresh_tree`)."""
    splice(scene, params)               # refuse unknown fields early
    if sphere_bvh and set(params) & set(SPHERE_GEOM_FIELDS):
        raise ValueError(
            f"sphere_bvh with the sphere geometry parameters "
            f"{sorted(set(params) & set(SPHERE_GEOM_FIELDS))}: the sphere "
            f"BVH would keep the spheres' starting boxes")
    pixels = None
    if mesh is not None:
        n_pixels = width * height
        if n_pixels % mesh.size:
            raise ValueError(f"{n_pixels} pixels do not divide over "
                             f"{mesh.size} ranks")
        if device is not None and not sharding.same_device(device,
                                                           mesh.device):
            raise ValueError(f"the step's device {device} is not the "
                             f"mesh's {mesh.device}")
        device = mesh.device
        pixels = sharding.strip(mesh, n_pixels)
        scene = sharding.replicate_scene(scene, mesh)
        camera = Camera(*(sharding.broadcast(mesh, t.to(device))
                          for t in camera))
    device = torch.device("cuda" if device is None else device)
    scene, camera = scene_to(scene, device), camera_to(camera, device)
    flags = SceneFlags.of(scene)._replace(sphere_bvh=sphere_bvh)
    if set(params) & CENTRE_FIELDS:
        flags = flags._replace(moving=True)
    require_trainable(scene, flags)
    pixel_ids = torch.arange(*(pixels or (0, width * height)),
                             device=scene.device)

    def loss_fn(p, target, seed):
        return image_loss(p, scene, camera, target, pixel_ids, width=width,
                          height=height, spp=spp, max_depth=max_depth,
                          seed=seed, engine=engine, engine_kw=engine_kw,
                          flags=flags)

    return TrainStep(scene, camera, params, loss_fn, lr, scene.device, flags,
                     mesh, pixels)
