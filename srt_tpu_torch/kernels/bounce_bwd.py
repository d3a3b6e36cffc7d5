"""The VJP of one bounce (kernel B5): the backward of the train step.

Replaces ``srt_tpu/pallas/bounce_bwd.py`` (``fused_bounce_bwd`` launching
``_bwd_kernel``, ``bounce_bwd.py:76-328``) under frozen geometry. Two
versions of the same function:

* :func:`bounce_bwd_reference`, the plain version: ``torch.autograd`` of
  the plain step :func:`kernels.bounce.bounce_step_ref`, which detaches
  nothing -- the gradient goes through the BSDF sample and the Beckmann
  pdf, as the JAX package's backward kernel's does (ROADMAP C2);
* ``csrc/bounce_bwd.cu``: per lane, the forward's closest hit replayed in
  float, the winner's ``t`` recomputed with tangents, and the forward's
  own shading code run in forward-mode dual numbers (two passes of seven
  tangents), each Jacobian column contracted with the cotangent. Per-lane
  material cotangents are segment-summed here with ``index_add_`` into the
  (M, 14) table, as ``bounce_bwd.py:301-316`` does with ``.at[].add``.

:func:`bounce_bwd` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back. ``index_add_`` on CUDA
floats is atomic, so the table's sums differ in their last bits from run
to run.
"""
from __future__ import annotations

import ctypes

import torch

from srt_tpu_torch.kernels.bounce import (_TABLES, MAT_GRAD_COLS, StepSpec,
                                          bounce_step_ref, check_state,
                                          table_args)
from srt_tpu_torch.kernels.build import launch
from srt_tpu_torch.scene.ir import (SPECULAR_MATS, MaterialType, SceneFlags,
                                    TorchScene, require_covered)

#: Kernel launches made by :func:`bounce_bwd` (the CUDA path only).
LAUNCHES_BWD = 0

ROWS = ("o", "d", "beta", "radiance")


def require_bwd_kernel(scene: TorchScene, flags: SceneFlags) -> None:
    """Raise unless the backward gives this scene's exact gradient under
    frozen geometry: the counterpart of ``bwd_kernel_available``
    (``bounce_bwd.py:58-73``) as an explicit check that reads no
    environment variable. Triangles are refused here: the kernel has no
    external-hit input, so it would differentiate a triangle lane as if
    the triangle were not there; and so are media and the specular
    materials, whose sweep and branch the backward lacks, whatever the
    coverage gate admits. The parity estimator and moving spheres
    the coverage gate refuses; geometric parameters
    ``diff.inverse.splice``."""
    if scene.n_tris:
        raise NotImplementedError(
            "srt_tpu_torch cannot differentiate triangle scenes yet: the "
            "backward kernel has no external-hit mode (ROADMAP A13)")
    if scene.n_media:
        raise NotImplementedError(
            "srt_tpu_torch cannot differentiate participating media yet: "
            "the backward kernel has no media sweep (ROADMAP A13)")
    specular = sorted(MaterialType(m).name for m in
                      set(flags.mat_kinds) & SPECULAR_MATS)
    if specular:
        raise NotImplementedError(
            f"srt_tpu_torch cannot differentiate {specular} yet: the "
            "backward kernel has no specular branch (ROADMAP A13)")
    require_covered(scene, flags)


def bounce_bwd_reference(scene: TorchScene, flags: SceneFlags,
                         mat: torch.Tensor, state: dict, ct: dict,
                         spec: StepSpec):
    """Plain version: ``torch.autograd.grad`` of :func:`bounce_step_ref`.
    ``ct`` holds the cotangents of the step's ``o d beta radiance``.
    Returns ``(d_state, d_mat)``: the cotangents of the inputs' ``o d beta
    radiance`` and of the (M, 14) material table."""
    with torch.enable_grad():
        leaves = {k: state[k].detach().requires_grad_() for k in ROWS}
        mat = mat.detach().requires_grad_()
        out = bounce_step_ref(scene, flags, mat, dict(state, **leaves), spec)
        grads = torch.autograd.grad([out[k] for k in ROWS],
                                    [leaves[k] for k in ROWS] + [mat],
                                    [ct[k] for k in ROWS],
                                    allow_unused=True)
    zero = [torch.zeros_like(v) for v in list(leaves.values()) + [mat]]
    grads = [z if g is None else g for g, z in zip(grads, zero)]
    return dict(zip(ROWS, grads[:4])), grads[4]


class _BwdArgs(ctypes.Structure):
    """``BounceBwdArgs`` of ``csrc/bounce_bwd.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "beta", "rad", "salt", "depth", "alive", "ct_o", "ct_d",
        "ct_beta", "ct_rad", "g_o", "g_d", "g_beta", "g_rad", "g_mat",
        "wmat", *_TABLES)]
        + [(name, ctypes.c_int) for name in (
            "n", "n_sph", "n_rect", "n_mat", "n_light", "n_atlas",
            "max_depth", "rr_start")]
        + [("pdf_floor", ctypes.c_float)])


def bwd_args(scene: TorchScene, tables: dict, state: dict, ct: dict,
             spec: StepSpec) -> tuple[_BwdArgs, tuple]:
    """The checked arguments of one ``csrc/bounce_bwd.cu`` launch and the
    outputs it writes: per-lane ``(d_state, d_mat_lane (N, 10), material
    id (N,) int32)``, before the segment sum."""
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
    wmat = torch.empty((n,), dtype=torch.int32, device=dev)
    args = _BwdArgs(
        **{k: state[k].data_ptr() for k in ("o", "d", "beta", "salt", "depth",
                                            "alive")},
        rad=state["radiance"].data_ptr(),
        ct_o=ctc["o"].data_ptr(), ct_d=ctc["d"].data_ptr(),
        ct_beta=ctc["beta"].data_ptr(), ct_rad=ctc["radiance"].data_ptr(),
        g_o=g["o"].data_ptr(), g_d=g["d"].data_ptr(),
        g_beta=g["beta"].data_ptr(), g_rad=g["radiance"].data_ptr(),
        g_mat=g_mat.data_ptr(), wmat=wmat.data_ptr(),
        **table_args(scene, tables), n=n, max_depth=spec.max_depth,
        rr_start=min(spec.rr_start, 2 ** 31 - 1), pdf_floor=spec.pdf_floor)
    return args, (g, g_mat, wmat)


def lane_cotangents(scene: TorchScene, tables: dict, state: dict, ct: dict,
                    spec: StepSpec):
    """Launch ``csrc/bounce_bwd.cu``; returns its outputs (see
    :func:`bwd_args`)."""
    global LAUNCHES_BWD
    args, outs = bwd_args(scene, tables, state, ct, spec)
    launch("srt_bounce_bwd", args, state["alive"].device)
    LAUNCHES_BWD += 1
    return outs


def segment_sum(g_mat: torch.Tensor, wmat: torch.Tensor,
                n_mat: int) -> torch.Tensor:
    """Per-lane material cotangents (N, 10) summed by material into the
    (M, 14) table's differentiable columns."""
    per_mat = torch.zeros((n_mat, g_mat.shape[1]), dtype=g_mat.dtype,
                          device=g_mat.device)
    per_mat.index_add_(0, wmat.long(), g_mat)
    d_mat = torch.zeros((n_mat, 14), dtype=g_mat.dtype, device=g_mat.device)
    d_mat[:, list(MAT_GRAD_COLS)] = per_mat
    return d_mat


def bounce_bwd(scene: TorchScene, flags: SceneFlags, tables: dict,
               state: dict, ct: dict, spec: StepSpec):
    """The VJP of one bounce at ``state`` (the inputs of
    :func:`kernels.bounce.bounce_fwd`) for the cotangents ``ct``: returns
    ``(d_state, d_mat)`` as :func:`bounce_bwd_reference` does. The plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    dev = state["alive"].device
    if dev.type == "cpu":
        return bounce_bwd_reference(scene, flags, tables["mat"], state, ct,
                                    spec)
    if dev.type != "cuda":
        raise ValueError(f"no bounce backward kernel for {dev}")
    g, g_mat, wmat = lane_cotangents(scene, tables, state, ct, spec)
    return g, segment_sum(g_mat, wmat, tables["mat"].shape[0])
