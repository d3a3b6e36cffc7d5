"""The bounce as a differentiable function (counterpart of
``srt_tpu/pallas/bounce_vjp.py``), in two forms that share the forward
kernel B2 and save only the bounce's inputs:

* :class:`BounceCore`, the split core (``bounce_vjp.py:89-117``): its
  backward launches the VJP kernel B5. Exact under frozen geometry on the
  scenes B5 covers (:func:`kernels.bounce_bwd.bwd_kernel_available`):
  every family of the render kernels but triangles and moving spheres,
  the rich families (specular branch, media, checker, noise and image
  textures, sphere lights) through B5's rich instantiation. The JAX
  package's split core defers its noise and image textures to an epilogue
  outside its custom VJP; the port evaluates them inside both kernels,
  and B5 differentiates them as XLA differentiates that epilogue: the
  image lookup's cotangent in the uv is zero (nearest-neighbour lookup),
  the marble's goes to the hit point. So nothing is left outside.
* :class:`BounceHybrid`, the hybrid (``bounce_vjp.py:40-84``): its backward
  replays the plain bounce :func:`kernels.bounce.bounce_step_ref` under
  autograd on the saved inputs and takes ``torch.autograd.grad`` of it,
  the counterpart of ``jax.vjp(bounce_step)``. In that replay each lane's
  winning sphere comes from kernel B6 (:mod:`kernels.spheres`), detached,
  and its hit is re-derived differentiably
  (``render.intersect.assemble_sphere_hit``); on a triangle scene the
  triangle hit is the forward's, from B3 or B4, detached as
  ``intersect_tris_via_pallas`` detaches it (``intersect.py:379-403``). It
  gives the gradients of the scene's geometric tensors (sphere centres and
  radii, rect planes) and takes the scenes B5 does not cover: moving
  spheres, triangles and the parity estimator, whose ``stale`` plane it
  passes on (no gradient).

:func:`bounce_step_auto` chooses between them as ``bounce_vjp.py:120-138``
does. A scene the bounce kernel's gate refuses (mesh-bounded media, past
its table caps: ``SceneFlags.fused_bounce`` false) takes neither:
its bounce is the plain bounce under autograd (:func:`bounce_plain`), as
the JAX package differentiates its XLA bounce there. On CPU tensors the
kernels are their plain versions.
"""
from __future__ import annotations

import torch

from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.kernels import spheres
from srt_tpu_torch.kernels.bounce import (StepSpec, bounce_fwd,
                                          bounce_step_ref)
from srt_tpu_torch.kernels.bounce_bwd import (ROWS, bounce_bwd,
                                              bwd_kernel_available,
                                              replay_vjp)
from srt_tpu_torch.scene.ir import GEOM_FIELDS, SceneFlags, TorchScene


class BounceCore(torch.autograd.Function):
    """``(o, d, beta, radiance, mat) -> (o', d', beta', radiance', depth',
    alive')`` with the state's integer fields and the scene as constants.
    Differentiable in the four (N, 3) rows and the (M, 14) material
    table."""

    @staticmethod
    def forward(ctx, o, d, beta, radiance, mat, time, salt, depth, alive,
                scene: TorchScene, flags: SceneFlags, tables: dict,
                spec: StepSpec):
        state = dict(o=o, d=d, beta=beta, radiance=radiance, time=time,
                     salt=salt, depth=depth, alive=alive)
        tabs = dict(tables, mat=mat)
        out = bounce_fwd(scene, flags, tabs, state, spec)
        ctx.save_for_backward(o, d, beta, radiance, mat, salt, depth, alive)
        ctx.statics = (scene, flags, tables, spec, time)
        ctx.mark_non_differentiable(out["depth"], out["alive"])
        return (out["o"], out["d"], out["beta"], out["radiance"],
                out["depth"], out["alive"])

    @staticmethod
    def backward(ctx, g_o, g_d, g_beta, g_rad, _g_depth, _g_alive):
        o, d, beta, radiance, mat, salt, depth, alive = ctx.saved_tensors
        scene, flags, tables, spec, time = ctx.statics
        state = dict(o=o, d=d, beta=beta, radiance=radiance, time=time,
                     salt=salt, depth=depth, alive=alive)
        ct = dict(zip(ROWS, (g_o, g_d, g_beta, g_rad)))
        d_state, d_mat = bounce_bwd(scene, flags, dict(tables, mat=mat),
                                    state, ct, spec)
        return (d_state["o"], d_state["d"], d_state["beta"],
                d_state["radiance"], d_mat) + (None,) * 8


def bounce_core(scene: TorchScene, flags: SceneFlags, tables: dict,
                state: dict, spec: StepSpec) -> dict:
    """One differentiable bounce of ``state`` (see
    ``kernels.bounce.bounce_step_ref`` for its fields). Gradients reach
    ``tables["mat"]`` and, through it, the parameters it was built from."""
    o, d, beta, radiance, depth, alive = BounceCore.apply(
        state["o"], state["d"], state["beta"], state["radiance"],
        tables["mat"], state["time"], state["salt"], state["depth"],
        state["alive"], scene, flags, tables, spec)
    return dict(o=o, d=d, beta=beta, radiance=radiance, depth=depth,
                alive=alive, time=state["time"], salt=state["salt"])


def hybrid_vjp(scene: TorchScene, flags: SceneFlags, tables: dict,
               state: dict, ct: dict, spec: StepSpec, geom: dict,
               tri=None):
    """The hybrid backward of one bounce at ``state`` for the cotangents
    ``ct`` of its ``o d beta radiance``: ``torch.autograd`` of the plain
    bounce (:func:`kernels.bounce_bwd.replay_vjp`) with the sphere winner
    from :func:`kernels.spheres.sphere_winner` (B6 on CUDA tensors) and the
    triangle hit ``tri`` (the forward's, from B3 or B4), both detached.
    ``geom`` names the geometric tensors to differentiate (a subset of the
    scene's :data:`GEOM_FIELDS`). Returns ``(d_state, d_mat, d_geom)``:
    the cotangents of the input rows, of the (M, 14) material table and of
    each ``geom`` tensor. With the plain sweep's winner instead of B6's,
    the same replay is the plain version the hybrid is held against."""
    with torch.no_grad():
        sph = (spheres.sphere_winner(scene, tables["sph"], state["o"],
                                     state["d"], state["time"])
               if scene.n_spheres else None)
    return replay_vjp(scene, flags, tables["mat"], state, ct, spec, geom,
                      tri, sph)


class BounceHybrid(torch.autograd.Function):
    """``(o, d, beta, radiance, mat, *geom) -> (o', d', beta', radiance',
    depth', alive')``: kernel B2 forward, the hybrid backward
    (:func:`hybrid_vjp`). ``geom`` are the scene's geometric tensors to
    differentiate, named in the statics; the forward saves only the
    inputs."""

    @staticmethod
    def forward(ctx, o, d, beta, radiance, mat, time, salt, depth, alive,
                statics: tuple, *geom):
        scene, flags, tables, spec, tri, _names = statics
        state = dict(o=o, d=d, beta=beta, radiance=radiance, time=time,
                     salt=salt, depth=depth, alive=alive)
        out = bounce_fwd(scene, flags, dict(tables, mat=mat), state, spec,
                         tri)
        ctx.save_for_backward(o, d, beta, radiance, mat, time, salt, depth,
                              alive, *geom)
        ctx.statics = statics
        extra = (out["stale"],) if "stale" in out else ()
        ctx.mark_non_differentiable(out["depth"], out["alive"], *extra)
        return (out["o"], out["d"], out["beta"], out["radiance"],
                out["depth"], out["alive"], *extra)

    @staticmethod
    def backward(ctx, g_o, g_d, g_beta, g_rad, _g_depth, _g_alive, *_g):
        o, d, beta, radiance, mat, time, salt, depth, alive, *geom = \
            ctx.saved_tensors
        scene, flags, tables, spec, tri, names = ctx.statics
        state = dict(o=o, d=d, beta=beta, radiance=radiance, time=time,
                     salt=salt, depth=depth, alive=alive)
        ct = dict(zip(ROWS, (g_o, g_d, g_beta, g_rad)))
        d_state, d_mat, d_geom = hybrid_vjp(
            scene, flags, dict(tables, mat=mat), state, ct, spec,
            dict(zip(names, geom)), tri)
        return ((d_state["o"], d_state["d"], d_state["beta"],
                 d_state["radiance"], d_mat) + (None,) * 5
                + tuple(d_geom[k] for k in names))


def geometric_params(scene: TorchScene) -> dict:
    """The scene's geometric tensors that require a gradient, by name."""
    return {k: getattr(scene, k) for k in sorted(GEOM_FIELDS)
            if isinstance(getattr(scene, k), torch.Tensor)
            and getattr(scene, k).requires_grad}


def bounce_hybrid(scene: TorchScene, flags: SceneFlags, tables: dict,
                  state: dict, spec: StepSpec, geom: dict,
                  walk: dict | None = None) -> dict:
    """One bounce of ``state`` through :class:`BounceHybrid`. On a triangle
    scene ``walk`` is :func:`kernels.intersect.pack_walk` of it: each
    lane's closest triangle comes from B3 or B4 before the forward."""
    tri = _closest_tris(scene, walk, state)
    o, d, beta, radiance, depth, alive, *stale = BounceHybrid.apply(
        state["o"], state["d"], state["beta"], state["radiance"],
        tables["mat"], state["time"], state["salt"], state["depth"],
        state["alive"], (scene, flags, tables, spec, tri, tuple(geom)),
        *geom.values())
    out = dict(o=o, d=d, beta=beta, radiance=radiance, depth=depth,
               alive=alive, time=state["time"], salt=state["salt"])
    if stale:
        out["stale"] = stale[0]
    return out


def _closest_tris(scene: TorchScene, walk: dict | None, state: dict):
    """Each lane's closest triangle from B3 or B4, detached (None without
    triangles)."""
    if not scene.n_tris:
        return None
    with torch.no_grad():
        return ki.closest_tris(scene, walk, state["o"].detach(),
                               state["d"].detach())


def bounce_plain(scene: TorchScene, flags: SceneFlags, tables: dict,
                 state: dict, spec: StepSpec,
                 walk: dict | None = None) -> dict:
    """One bounce of ``state`` as the plain bounce under autograd
    (:func:`kernels.bounce.bounce_step_ref`), for the scenes the bounce
    kernel's gate refuses; on a triangle scene the hit comes from B3 or B4
    (``walk``), detached."""
    return bounce_step_ref(scene, flags, tables["mat"], state, spec,
                           _closest_tris(scene, walk, state))


def bounce_step_auto(scene: TorchScene, flags: SceneFlags, tables: dict,
                     state: dict, spec: StepSpec,
                     walk: dict | None = None) -> dict:
    """One differentiable bounce with the backward chosen as
    ``bounce_vjp.py:120-138`` chooses it: the backward kernel B5 when it is
    exact (no geometric tensor of the scene requires a gradient, and B5
    covers the scene), else the hybrid, which differentiates the scene's
    geometric tensors that require one. The JAX package passes that
    choice in as ``frozen_geometry``, since a traced tensor cannot say
    whether it is differentiated; here ``requires_grad`` says it. Where
    the bounce kernel's gate refuses the scene, :func:`bounce_plain`."""
    if not flags.fused_bounce:
        return bounce_plain(scene, flags, tables, state, spec, walk)
    geom = geometric_params(scene)
    if not geom and bwd_kernel_available(scene, flags):
        return bounce_core(scene, flags, tables, state, spec)
    return bounce_hybrid(scene, flags, tables, state, spec, geom, walk)
