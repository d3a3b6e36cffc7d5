"""Closest triangle hit over the scene's BVH: kernels B3 and B4.

**B3**, the single-level walk, replaces
``srt_tpu/pallas/intersect.py:_kernel`` (launched by
``intersect_tris_pallas``, ``intersect.py:73-268``). Two versions of the
same function:

* :func:`intersect_tris_reference`, the plain version: the lockstep
  skip-link walk of :func:`srt_tpu_torch.render.intersect.intersect_tris`;
* ``csrc/intersect_tris.cu``, hand-written CUDA for ``sm_90a``: one thread
  per ray on the same walk (``csrc/tri_bvh.cuh``), where the TPU kernel
  walks one scalar cursor per 1024-ray tile over the union of its rays'
  nodes.

**B4**, the two-level walk for meshes beyond the single-level budget,
replaces ``srt_tpu/pallas/intersect_big.py:_kernel`` (launched by
``intersect_tris_pallas_big``): :func:`intersect_tris_big_reference`
(:func:`srt_tpu_torch.render.intersect.intersect_tris_big`) and
``csrc/intersect_big.cu``, one thread per ray over the top tree and each
cluster it enters. The TPU kernel's per-tile scalar cursor, one-hot lane
extracts and blocking DMA of a padded cluster into VMEM are not carried
over.

:func:`intersect_tris` and :func:`intersect_tris_big` take the plain
version for CPU tensors and launch their kernel for CUDA tensors; they
never fall back. Which of the two a scene takes is the JAX package's rule,
:func:`srt_tpu_torch.render.intersect.two_level`, applied once a render by
the engine. Both return ``(t, u, v, idx)``: ``t = 3e38``, ``u = v = 0``
and ``idx = 0`` on a miss.
"""
from __future__ import annotations

import ctypes

import torch

from srt_tpu_torch.kernels.build import launch
from srt_tpu_torch.render.intersect import cluster_records
from srt_tpu_torch.render.intersect import \
    intersect_tris as intersect_tris_reference
from srt_tpu_torch.render.intersect import \
    intersect_tris_big as intersect_tris_big_reference
from srt_tpu_torch.scene.ir import TorchScene

#: Kernel launches made by :func:`intersect_tris` (the CUDA path only).
LAUNCHES = 0
#: Kernel launches made by :func:`intersect_tris_big` (the CUDA path only).
LAUNCHES_BIG = 0


def pack_tables(scene: TorchScene) -> dict:
    """The kernel's tables: nodes as (B, 9) float32 records (lo, hi, then
    skip, first and count as int32 bit patterns) and triangles as (T, 9)
    float32 records (p0, p1, p2), one record contiguous."""
    links = torch.stack([scene.bvh_skip, scene.bvh_first, scene.bvh_count],
                        1).to(torch.int32).view(torch.float32)
    nodes = torch.cat([scene.bvh_lo, scene.bvh_hi, links], 1)
    tris = torch.cat([scene.tri_p0, scene.tri_p1, scene.tri_p2], 1)
    return dict(nodes=nodes.contiguous(), tris=tris.contiguous())


def _links(*cols: torch.Tensor) -> torch.Tensor:
    return torch.stack(cols, 1).to(torch.int32).view(torch.float32)


def pack_big_tables(scene: TorchScene) -> dict:
    """B4's tables, one record contiguous: the top tree (Bt, 9) as lo, hi,
    then skip, cluster and tri_base as int32 bit patterns; the cluster
    nodes (Nc*node_cap, 9) as lo, hi, then local skip, first and count;
    the cluster triangles (Nc*tri_cap, 9) as p0, p1, p2; and the caps."""
    rec = cluster_records(scene)
    top = torch.cat([scene.top_lo, scene.top_hi,
                     _links(scene.top_skip, scene.top_cluster,
                            scene.top_tri_base)], 1)
    nodes = torch.cat([rec["lo"], rec["hi"],
                       _links(rec["skip"], rec["first"], rec["count"])], 1)
    return dict(top=top.contiguous(), nodes=nodes.contiguous(),
                tris=rec["p"].contiguous(), node_cap=rec["node_cap"],
                tri_cap=rec["tri_cap"])


class _Args(ctypes.Structure):
    """``IntersectTrisArgs`` of ``csrc/intersect_tris.cu``, field for
    field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "nodes", "tris", "t", "u", "v", "idx")]
        + [("n", ctypes.c_int), ("n_nodes", ctypes.c_int)])


class _BigArgs(ctypes.Structure):
    """``IntersectBigArgs`` of ``csrc/intersect_big.cu``, field for
    field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "top", "nodes", "tris", "t", "u", "v", "idx")]
        + [(name, ctypes.c_int) for name in (
            "n", "n_top", "node_cap", "tri_cap")])


def _check_rays(o: torch.Tensor, d: torch.Tensor) -> None:
    dev, n = o.device, o.shape[0]
    for k, t in (("o", o), ("d", d)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n, 3)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"rays {k!r}: want contiguous float32 ({n}, 3) "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _outputs(n: int, dev) -> tuple:
    return tuple(torch.empty((n,), dtype=dt, device=dev) for dt in
                 (torch.float32,) * 3 + (torch.int32,))


def kernel_args(tables: dict, o: torch.Tensor,
                d: torch.Tensor) -> tuple[_Args, tuple]:
    """The checked arguments of one ``csrc/intersect_tris.cu`` launch and
    the outputs ``(t, u, v, idx)`` it writes."""
    dev, n = o.device, o.shape[0]
    _check_rays(o, d)
    for k in ("nodes", "tris"):
        t = tables[k]
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 9
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"table {k!r} must be contiguous float32 "
                             f"(*, 9) on {dev}")
    out = _outputs(n, dev)
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


def big_kernel_args(tables: dict, o: torch.Tensor,
                    d: torch.Tensor) -> tuple[_BigArgs, tuple]:
    """The checked arguments of one ``csrc/intersect_big.cu`` launch and
    the outputs ``(t, u, v, idx)`` it writes."""
    dev, n = o.device, o.shape[0]
    _check_rays(o, d)
    for k in ("top", "nodes", "tris"):
        t = tables[k]
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 9
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"table {k!r} must be contiguous float32 "
                             f"(*, 9) on {dev}")
    node_cap, tri_cap = tables["node_cap"], tables["tri_cap"]
    if (tables["nodes"].shape[0] % node_cap
            or tables["tris"].shape[0] != tables["nodes"].shape[0]
            // node_cap * tri_cap):
        raise ValueError("cluster tables must hold whole padded blocks")
    out = _outputs(n, dev)
    args = _BigArgs(o=o.data_ptr(), d=d.data_ptr(),
                    **{k: tables[k].data_ptr() for k in ("top", "nodes",
                                                         "tris")},
                    **{k: x.data_ptr() for k, x in zip(("t", "u", "v", "idx"),
                                                       out)},
                    n=n, n_top=tables["top"].shape[0], node_cap=node_cap,
                    tri_cap=tri_cap)
    return args, out


def intersect_tris_big(scene: TorchScene, tables: dict, o: torch.Tensor,
                       d: torch.Tensor):
    """Each ray's closest triangle over the two-level BVH ``(t, u, v,
    idx)``: the plain version for CPU tensors, kernel B4 for CUDA tensors.
    ``tables`` is :func:`pack_big_tables` of ``scene``."""
    global LAUNCHES_BIG
    if o.device.type == "cpu":
        return intersect_tris_big_reference(scene, o, d)
    if o.device.type != "cuda":
        raise ValueError(f"no two-level triangle kernel for {o.device}")
    args, out = big_kernel_args(tables, o, d)
    launch("srt_intersect_big", args, o.device)
    LAUNCHES_BIG += 1
    return out
