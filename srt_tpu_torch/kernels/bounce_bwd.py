"""The VJP of one bounce (kernel B5): the backward of the train step.

Replaces ``srt_tpu/pallas/bounce_bwd.py`` (``fused_bounce_bwd`` launching
``_bwd_kernel``, ``bounce_bwd.py:76-328``) under frozen geometry. Two
versions of the same function:

* :func:`bounce_bwd_reference`, the plain version: ``torch.autograd`` of
  the plain step :func:`kernels.bounce.bounce_step_ref`, which detaches
  nothing -- the gradient goes through the BSDF sample and the Beckmann
  pdf, as the JAX package's backward kernel's does (ROADMAP C2). It is
  :func:`replay_vjp` with no geometric tensor, the same code the hybrid
  backward (:mod:`kernels.bounce_vjp`) replays;
* ``csrc/bounce_bwd.cu``: per lane, the forward's closest hit replayed in
  float, the winner's ``t`` recomputed with tangents, and the forward's
  own shading code run in forward-mode dual numbers, each Jacobian column
  contracted with the cotangent; the columns in passes of K tangents,
  each pass a thread of its own (the widths and the column map are
  ``csrc/bwd_columns.cuh``'s); on a scene with any of
  :func:`scene.ir.rich_families` its rich
  instantiation (``kRich``), which also replays the media sweep and
  differentiates the specular branch, the media events, the checker's
  colours, the marble and sphere lights (17 columns instead of 14). Where
  a wavefront's 32-lane tiles fit in the blocks the card holds at once,
  a block a tile; else one cooperative launch that lists the live lanes
  on the card, sweeps only them and writes the dead lanes' outputs, so
  its time follows the live lanes. Either gives the bits of a sweep over
  every lane, and neither reads the card from the host.
  Per-lane material cotangents are summed by material into the (M, 14)
  table by :func:`kernels.segment.material_sum` (``csrc/segment_sum.cu``,
  in an order fixed by the lanes, so the table's bits repeat run to run),
  as ``bounce_bwd.py:301-316`` does with ``.at[].add``.

:func:`bounce_bwd` takes the plain version for CPU tensors and launches
the kernels for CUDA tensors; it never falls back, and it raises for a
scene the kernel cannot differentiate (:func:`require_bwd_kernel`), on
either device.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from srt_tpu_torch import trace as tracer
from srt_tpu_torch.kernels.bounce import (_RICH_FIELDS, _TABLES,
                                          MAT_GRAD_COLS, StepSpec,
                                          bounce_step_ref, check_state,
                                          rich_args, table_args)
from srt_tpu_torch.kernels.build import launch, load_library
from srt_tpu_torch.kernels.segment import material_sum
from srt_tpu_torch.scene.ir import SceneFlags, TorchScene, require_trainable

ROWS = ("o", "d", "beta", "radiance")


def _bwd_kernel_gaps(scene: TorchScene, flags: SceneFlags) -> list[str]:
    """What this scene has that the backward kernel cannot differentiate:
    JAX's gate (``bounce_bwd.py:58-73``)."""
    gaps = []
    if not flags.fused_bounce:
        gaps.append("a scene the bounce kernels' gate refuses (mesh-bounded "
                    "media, past their table caps): it replays their bounce")
    if flags.ref_parity:
        gaps.append("the parity estimator: it replays the default one")
    if scene.n_tris:
        gaps.append("triangle scenes: it has no external-hit mode")
    if flags.moving:
        gaps.append("moving spheres: it replays static spheres")
    if scene.atlas.requires_grad:
        gaps.append("an image atlas that requires a gradient: it has no "
                    "texel cotangents")
    return gaps


def bwd_kernel_available(scene: TorchScene, flags: SceneFlags) -> bool:
    """Whether the backward kernel gives this scene's exact gradient under
    frozen geometry: the counterpart of ``bwd_kernel_available``
    (``bounce_bwd.py:58-73``), reading no environment variable. Moving
    spheres go to the hybrid backward as there, and so do triangles (the
    kernel has no external-hit input, so it would differentiate a
    triangle lane as if the triangle were not there), and so do the
    parity estimator and an image atlas that requires a gradient (the
    kernel gives no texel cotangents; JAX's keeps its kernel and
    differentiates the image epilogue outside it,
    ``pallas/bounce_vjp.py:108-114``); a scene the bounce kernels' gate
    refuses takes autograd of the plain bounce."""
    return not _bwd_kernel_gaps(scene, flags)


def require_bwd_kernel(scene: TorchScene, flags: SceneFlags) -> None:
    """Raise unless the backward kernel covers this scene (see
    :func:`bwd_kernel_available`). :func:`bounce_bwd` checks this before
    it runs; the train step gives such a scene the hybrid backward
    instead (``kernels.bounce_vjp.bounce_step_auto``)."""
    gaps = _bwd_kernel_gaps(scene, flags)
    if gaps:
        raise NotImplementedError(
            f"the backward kernel cannot differentiate {gaps[0]}; the train "
            "step takes the hybrid backward or autograd of the plain bounce "
            "for it")
    require_trainable(scene, flags)


def _detached(scene: TorchScene) -> TorchScene:
    return dataclasses.replace(scene, **{
        f.name: getattr(scene, f.name).detach()
        for f in dataclasses.fields(TorchScene)
        if isinstance(getattr(scene, f.name), torch.Tensor)})


def replay_vjp(scene: TorchScene, flags: SceneFlags, mat: torch.Tensor,
               state: dict, ct: dict, spec: StepSpec, geom: dict | None = None,
               tri=None, sph=None):
    """``torch.autograd.grad`` of :func:`bounce_step_ref` at ``state`` for
    the cotangents ``ct`` of its ``o d beta radiance``. ``geom`` names the
    scene's geometric tensors to differentiate too (a subset of
    ``GEOM_FIELDS``); ``tri`` and ``sph`` are the triangles' and the
    spheres' winners when the caller has them (else the plain step finds
    them itself). Returns ``(d_state, d_mat, d_geom)``: the cotangents of
    the input rows, of the (M, 14) material table and of each ``geom``
    tensor."""
    geom = geom or {}
    with torch.enable_grad():
        rows = {k: state[k].detach().requires_grad_() for k in ROWS}
        mat = mat.detach().requires_grad_()
        leaves = {k: v.detach().requires_grad_() for k, v in geom.items()}
        out = bounce_step_ref(dataclasses.replace(_detached(scene), **leaves),
                              flags, mat, dict(state, **rows), spec, tri, sph)
        inputs = [rows[k] for k in ROWS] + [mat] + list(leaves.values())
        grads = torch.autograd.grad([out[k] for k in ROWS], inputs,
                                    [ct[k] for k in ROWS], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, inputs)]
    return (dict(zip(ROWS, grads[:4])), grads[4],
            dict(zip(leaves, grads[5:])))


def bounce_bwd_reference(scene: TorchScene, flags: SceneFlags,
                         mat: torch.Tensor, state: dict, ct: dict,
                         spec: StepSpec):
    """Plain version: :func:`replay_vjp` with the geometry frozen. Returns
    ``(d_state, d_mat)``: the cotangents of the inputs' ``o d beta
    radiance`` and of the (M, 14) material table."""
    return replay_vjp(scene, flags, mat, state, ct, spec)[:2]


class _BwdArgs(ctypes.Structure):
    """``BounceBwdArgs`` of ``csrc/bounce_bwd.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "beta", "rad", "salt", "depth", "alive", "ct_o", "ct_d",
        "ct_beta", "ct_rad", "g_o", "g_d", "g_beta", "g_rad", "g_mat",
        "wmat", *_TABLES)]
        + [(name, ctypes.c_int) for name in (
            "n", "n_sph", "n_rect", "n_mat", "n_light", "n_atlas",
            "atlas_f32", "max_depth", "rr_start")]
        + [("pdf_floor", ctypes.c_float), ("med", ctypes.c_void_p),
           ("n_med", ctypes.c_int)]
        + _RICH_FIELDS
        + [("list", ctypes.c_void_p), ("barrier", ctypes.c_void_p),
           ("live", ctypes.c_void_p)])

# The grid barrier's counter of the launches over the list, by device and
# stream: zeroed once, never reset (launches on one stream meet in turn)
_BARRIERS: dict = {}


def _barrier(dev) -> int:
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream)
    if key not in _BARRIERS:
        _BARRIERS[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return _BARRIERS[key].data_ptr()


def bwd_args(scene: TorchScene, flags: SceneFlags, tables: dict,
             state: dict, ct: dict,
             spec: StepSpec) -> tuple[_BwdArgs, tuple]:
    """The checked arguments of one ``csrc/bounce_bwd.cu`` launch and the
    outputs it writes: per-lane ``(d_state, d_mat_lane (N, 10), material
    id (N,) int32)``, before the segment sum. ``flags`` picks the
    instantiation on the host (``rich`` when the scene has any of
    :func:`scene.ir.rich_families`), with no device read. The kernel's
    scratch (the list of live lanes, each block's count, its draws)
    shares one buffer with the material ids, so the outputs keep it for
    as long as they live (a replay of the arguments writes into them).
    On the card a launch takes its stream's barrier counter, so launches
    on other streams may run at once."""
    dev = state["alive"].device
    n = check_state(state, tables, dev)
    ctc = {}
    for k in ROWS:
        c = ct[k].contiguous()
        if c.dtype != torch.float32 or tuple(c.shape) != (n, 3) \
                or c.device != dev:
            raise ValueError(f"cotangent {k!r}: want float32 ({n}, 3) on "
                             f"{dev}")
        ctc[k] = c
    g = {k: torch.empty_like(ctc[k]) for k in ROWS}
    g_mat = torch.empty((n, len(MAT_GRAD_COLS)), dtype=torch.float32,
                        device=dev)
    cuda = dev.type == "cuda"
    scratch = load_library().srt_bounce_bwd_scratch() if cuda else 0
    ids = torch.empty((2 * n + scratch,), dtype=torch.int32, device=dev)
    wmat = ids[:n]
    args = _BwdArgs(
        **{k: state[k].data_ptr() for k in ("o", "d", "beta", "salt", "depth",
                                            "alive")},
        rad=state["radiance"].data_ptr(),
        ct_o=ctc["o"].data_ptr(), ct_d=ctc["d"].data_ptr(),
        ct_beta=ctc["beta"].data_ptr(), ct_rad=ctc["radiance"].data_ptr(),
        g_o=g["o"].data_ptr(), g_d=g["d"].data_ptr(),
        g_beta=g["beta"].data_ptr(), g_rad=g["radiance"].data_ptr(),
        g_mat=g_mat.data_ptr(), wmat=wmat.data_ptr(),
        list=ids[n:].data_ptr(), barrier=_barrier(dev) if cuda else None,
        **table_args(scene, tables), n=n, max_depth=spec.max_depth,
        rr_start=min(spec.rr_start, 2 ** 31 - 1), pdf_floor=spec.pdf_floor,
        **rich_args(scene, flags, tables))
    return args, (g, g_mat, wmat)


def lane_cotangents(scene: TorchScene, flags: SceneFlags, tables: dict,
                    state: dict, ct: dict, spec: StepSpec, live=None):
    """Launch ``csrc/bounce_bwd.cu`` (its lean or its rich instantiation);
    returns its outputs (see :func:`bwd_args`). ``live``: the address the
    kernel adds the lanes it sweeps to (a tracer slot), or None."""
    args, outs = bwd_args(scene, flags, tables, state, ct, spec)
    args.live = live
    launch("srt_bounce_bwd", args, state["alive"].device)
    tracer.COUNTS["B5"] += 1
    tracer.COUNTS["B5 rich"] += args.rich
    return outs


def bounce_bwd(scene: TorchScene, flags: SceneFlags, tables: dict,
               state: dict, ct: dict, spec: StepSpec):
    """The VJP of one bounce at ``state`` (the inputs of
    :func:`kernels.bounce.bounce_fwd`) for the cotangents ``ct``: returns
    ``(d_state, d_mat)`` as :func:`bounce_bwd_reference` does. The plain
    version for CPU tensors, the CUDA kernel for CUDA tensors; a scene the
    kernel cannot differentiate raises on both (:func:`require_bwd_kernel`).
    Where the call records (:mod:`srt_tpu_torch.trace`), a ``B5`` launch
    span with its lanes and the live lanes it swept: counted by the
    kernel on the card, by a sum here on the CPU."""
    require_bwd_kernel(scene, flags)
    dev = state["alive"].device
    on = tracer.ON
    t0 = tracer.now() if on else 0
    if dev.type == "cpu":
        # B5 sweeps the spheres whatever ``flags.sphere_bvh`` says
        out = bounce_bwd_reference(scene, flags._replace(sphere_bvh=False),
                                   tables["mat"], state, ct, spec)
        if on:
            tracer.launch("B5", t0, state["alive"].shape[0],
                          state["alive"].sum())
        return out
    if dev.type != "cuda":
        raise ValueError(f"no bounce backward kernel for {dev}")
    addr, live = tracer.live_slot(dev) if on else (None, None)
    g, g_mat, wmat = lane_cotangents(scene, flags, tables, state, ct, spec,
                                     addr)
    if on:
        tracer.launch("B5", t0, state["alive"].shape[0], live)
    return g, material_sum(g_mat, wmat, tables["mat"].shape[0])
