"""Closest triangle hit over the scene's BVH (kernel B3).

Replaces ``srt_tpu/pallas/intersect.py:_kernel`` (launched by
``intersect_tris_pallas``, ``intersect.py:73-268``). Two versions of the
same function:

* :func:`intersect_tris_reference`, the plain version: the lockstep
  skip-link walk of :func:`srt_tpu_torch.render.intersect.intersect_tris`;
* ``csrc/intersect_tris.cu``, hand-written CUDA for ``sm_90a``: one thread
  per ray on the same walk (``csrc/tri_bvh.cuh``), where the TPU kernel
  walks one scalar cursor per 1024-ray tile over the union of its rays'
  nodes.

:func:`intersect_tris` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back. Both return
``(t, u, v, idx)``: ``t = 3e38``, ``u = v = 0`` and ``idx = 0`` on a miss.
"""
from __future__ import annotations

import ctypes

import torch

from srt_tpu_torch.kernels.build import launch
from srt_tpu_torch.render.intersect import \
    intersect_tris as intersect_tris_reference
from srt_tpu_torch.scene.ir import TorchScene

#: Kernel launches made by :func:`intersect_tris` (the CUDA path only).
LAUNCHES = 0


def pack_tables(scene: TorchScene) -> dict:
    """The kernel's tables: nodes as (B, 9) float32 records (lo, hi, then
    skip, first and count as int32 bit patterns) and triangles as (T, 9)
    float32 records (p0, p1, p2), one record contiguous."""
    links = torch.stack([scene.bvh_skip, scene.bvh_first, scene.bvh_count],
                        1).to(torch.int32).view(torch.float32)
    nodes = torch.cat([scene.bvh_lo, scene.bvh_hi, links], 1)
    tris = torch.cat([scene.tri_p0, scene.tri_p1, scene.tri_p2], 1)
    return dict(nodes=nodes.contiguous(), tris=tris.contiguous())


class _Args(ctypes.Structure):
    """``IntersectTrisArgs`` of ``csrc/intersect_tris.cu``, field for
    field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "nodes", "tris", "t", "u", "v", "idx")]
        + [("n", ctypes.c_int), ("n_nodes", ctypes.c_int)])


def kernel_args(tables: dict, o: torch.Tensor,
                d: torch.Tensor) -> tuple[_Args, tuple]:
    """The checked arguments of one ``csrc/intersect_tris.cu`` launch and
    the outputs ``(t, u, v, idx)`` it writes."""
    dev, n = o.device, o.shape[0]
    for k, t in (("o", o), ("d", d)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n, 3)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"rays {k!r}: want contiguous float32 ({n}, 3) "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for k in ("nodes", "tris"):
        t = tables[k]
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 9
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"table {k!r} must be contiguous float32 "
                             f"(*, 9) on {dev}")
    out = tuple(torch.empty((n,), dtype=dt, device=dev) for dt in
                (torch.float32,) * 3 + (torch.int32,))
    args = _Args(o=o.data_ptr(), d=d.data_ptr(),
                 nodes=tables["nodes"].data_ptr(),
                 tris=tables["tris"].data_ptr(),
                 **{k: x.data_ptr() for k, x in zip(("t", "u", "v", "idx"),
                                                    out)},
                 n=n, n_nodes=tables["nodes"].shape[0])
    return args, out


def intersect_tris(scene: TorchScene, tables: dict, o: torch.Tensor,
                   d: torch.Tensor):
    """Each ray's closest triangle ``(t, u, v, idx)`` (idx int64 from the
    plain version, int32 from the kernel): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors. ``tables`` is
    :func:`pack_tables` of ``scene``."""
    global LAUNCHES
    if o.device.type == "cpu":
        return intersect_tris_reference(scene, o, d)
    if o.device.type != "cuda":
        raise ValueError(f"no triangle kernel for {o.device}")
    args, out = kernel_args(tables, o, d)
    launch("srt_intersect_tris", args, o.device)
    LAUNCHES += 1
    return out
