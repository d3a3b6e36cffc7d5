"""Closest triangle hit over the scene's BVH: kernels B3 and B4.

**B3**, the single-level walk, replaces
``srt_tpu/pallas/intersect.py:_kernel`` (launched by
``intersect_tris_pallas``, ``intersect.py:73-268``). Two versions of the
same function:

* :func:`intersect_tris_reference`, the plain version: the lockstep
  skip-link walk of :func:`srt_tpu_torch.render.intersect.intersect_tris`;
* ``csrc/intersect_tris.cu``, hand-written CUDA for ``sm_90a``: the same
  walk over B4's 16-byte records (:func:`pack_tables`), each ray on G
  threads (:func:`walk_shares`) that take one node path and split a
  leaf's triangle tests, where the TPU kernel walks one scalar cursor per
  1024-ray tile over the union of its rays' nodes.

**B4**, the two-level walk for meshes beyond the single-level budget,
replaces ``srt_tpu/pallas/intersect_big.py:_kernel`` (launched by
``intersect_tris_pallas_big``): :func:`intersect_tris_big_reference`
(:func:`srt_tpu_torch.render.intersect.intersect_tris_big`) and
``csrc/intersect_big.cu``, one thread per ray walking the top tree and
each cluster it enters in one loop, over the 16-byte aligned records of
:func:`pack_big_tables` (the clusters back to back). The TPU
kernel's per-tile scalar cursor, one-hot lane extracts and blocking DMA
of a padded cluster into VMEM are not carried over, nor is the padding
of each cluster to the TPU's block.

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
from srt_tpu_torch.render.intersect import two_level
from srt_tpu_torch.scene.ir import TorchScene

#: Kernel launches made by :func:`intersect_tris` (the CUDA path only).
LAUNCHES = 0
#: Kernel launches made by :func:`intersect_tris_big` (the CUDA path only).
LAUNCHES_BIG = 0

#: the threads a ray may take for B3's walk (the kernel's template G)
WALK_SHARES = (1, 2, 4)
#: B3's rays times G up to this many threads (:func:`walk_shares`)
WALK_THREADS = 1 << 17


def _words(x: torch.Tensor) -> torch.Tensor:
    """Integers as float32 bit patterns, one column."""
    return x.to(torch.int32).view(torch.float32)[:, None]


def _tri_records(p0: torch.Tensor, p1: torch.Tensor,
                 p2: torch.Tensor) -> torch.Tensor:
    """(T, 12) triangle records: p0, e1 = p1 - p0, e2 = p2 - p0, each
    padded to four words with 0."""
    zero = torch.zeros_like(p0[:, :1])
    return torch.cat([p0, zero, p1 - p0, zero, p2 - p0, zero], 1)


def pack_tables(scene: TorchScene) -> dict:
    """B3's tables, B4's 16-byte aligned rows of float32 (int32 bit
    patterns where noted):

    * ``nodes`` (B, 8): lo, skip, hi, link (:func:`link_words` of the
      node's first triangle and count, ``count_bits`` wide; negative on an
      inner node);
    * ``tris`` (T, 12): p0, e1 = p1 - p0, e2 = p2 - p0, each padded to four
      words with 0, in BVH order.

    ``count_bits`` holds the widest leaf's count."""
    count_bits = max(int(scene.bvh_count.max()), 1).bit_length()
    links = link_words(scene.bvh_first, scene.bvh_count, count_bits)
    nodes = torch.cat([scene.bvh_lo, _words(scene.bvh_skip), scene.bvh_hi,
                       _words(links)], 1)
    tris = _tri_records(scene.tri_p0, scene.tri_p1, scene.tri_p2)
    return dict(nodes=nodes.contiguous(), tris=tris.contiguous(),
                count_bits=count_bits)


def walk_shares(n_rays: int, count_bits: int) -> int:
    """G, the threads each ray's walk takes in B3: the most of
    :data:`WALK_SHARES` with ``n_rays * G`` within :data:`WALK_THREADS`
    and no more shares than the widest leaf has triangles (``1 <<
    (count_bits - 1)`` bounds it). The outputs are the same at every G;
    the rule follows the times ``chip_smoke.py`` measures at each G
    (PERF.md §6)."""
    g = 1
    while (g * 2 in WALK_SHARES and n_rays * g * 2 <= WALK_THREADS
           and g * 2 <= 1 << (count_bits - 1)):
        g *= 2
    return g


def link_words(first: torch.Tensor, count: torch.Tensor,
               count_bits: int) -> torch.Tensor:
    """B4's cluster-node link words: ``first << count_bits | count`` as
    int32, negative on an inner node (``first == -1``). Raises if a first
    triangle or a count does not fit its bits."""
    first, count = first.long(), count.long()
    if bool(((first < -1) | (first >= 1 << (31 - count_bits))
             | (count < 0) | (count >= 1 << count_bits)).any()):
        raise ValueError(f"cluster links do not fit {31 - count_bits} bits "
                         f"of first triangle and {count_bits} of count")
    return (first * (1 << count_bits) + count).to(torch.int32)


def pack_big_tables(scene: TorchScene) -> dict:
    """B4's tables, 16-byte aligned rows of float32 (int32 bit patterns
    where noted):

    * ``top`` (Bt, 8): lo, skip, hi, cluster (-1 on an inner node);
    * ``nodes`` (N, 8): the clusters' nodes back to back, no padding: lo,
      local skip, hi, link (:func:`link_words`, ``count_bits`` wide);
    * ``tris`` (T, 12): the clusters' triangles back to back: p0, e1 = p1
      - p0, e2 = p2 - p0, each padded to four words with 0;
    * ``clusters`` (Nc, 4) int32: node base in ``nodes``, triangle base in
      ``tris``, tri_base (the global index of the cluster's triangle 0)
      and node count.

    A cluster's node count is its root's local skip (past its last node);
    its triangle count is the end of its last leaf."""
    rec = cluster_records(scene)
    node_cap, tri_cap = rec["node_cap"], rec["tri_cap"]
    nc, dev = scene.cl_tris.shape[0], scene.top_lo.device
    skip = rec["skip"].view(nc, node_cap).long()
    first = rec["first"].view(nc, node_cap).long()
    count = rec["count"].view(nc, node_cap).long()
    n_nodes = skip[:, 0]
    real = torch.arange(node_cap, device=dev)[None] < n_nodes[:, None]
    n_tris = torch.where(real & (first >= 0), first + count, 0).amax(1)
    real_tri = torch.arange(tri_cap, device=dev)[None] < n_tris[:, None]
    count_bits = max(int(count.max()), 1).bit_length()
    links = link_words(rec["first"], rec["count"], count_bits)
    keep = real.view(-1)
    nodes = torch.cat([rec["lo"][keep], _words(rec["skip"][keep]),
                       rec["hi"][keep], _words(links[keep])], 1)
    p = rec["p"][real_tri.view(-1)]
    tris = _tri_records(p[:, 0:3], p[:, 3:6], p[:, 6:9])
    leaf = scene.top_cluster >= 0
    tri_base = torch.zeros((nc,), dtype=torch.long, device=dev)
    tri_base[scene.top_cluster[leaf].long()] = scene.top_tri_base[leaf].long()
    clusters = torch.stack([torch.cumsum(n_nodes, 0) - n_nodes,
                            torch.cumsum(n_tris, 0) - n_tris, tri_base,
                            n_nodes], 1).to(torch.int32)
    top = torch.cat([scene.top_lo, _words(scene.top_skip), scene.top_hi,
                     _words(scene.top_cluster)], 1)
    return dict(top=top.contiguous(), nodes=nodes.contiguous(),
                tris=tris.contiguous(), clusters=clusters.contiguous(),
                count_bits=count_bits)


class _Args(ctypes.Structure):
    """``IntersectTrisArgs`` of ``csrc/intersect_tris.cu``, field for
    field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "nodes", "tris", "t", "u", "v", "idx")]
        + [(name, ctypes.c_int) for name in (
            "n", "n_nodes", "count_bits", "shares")])


class _BigArgs(ctypes.Structure):
    """``IntersectBigArgs`` of ``csrc/intersect_big.cu``, field for
    field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "top", "nodes", "tris", "clusters", "t", "u", "v", "idx")]
        + [(name, ctypes.c_int) for name in (
            "n", "n_top", "count_bits")])


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


def _check_tables(tables: dict, widths: dict, dev) -> None:
    """Each table ``k`` of ``widths`` a 16-byte aligned contiguous
    ``(*, width)`` tensor of its dtype on ``dev``."""
    for k, (dt, width) in widths.items():
        t = tables[k]
        if (t.dtype != dt or t.dim() != 2 or t.shape[1] != width
                or t.device != dev or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"table {k!r} must be 16-byte aligned "
                             f"contiguous {dt} (*, {width}) on {dev}")


def kernel_args(tables: dict, o: torch.Tensor,
                d: torch.Tensor) -> tuple[_Args, tuple]:
    """The checked arguments of one ``csrc/intersect_tris.cu`` launch and
    the outputs ``(t, u, v, idx)`` it writes."""
    dev, n = o.device, o.shape[0]
    _check_rays(o, d)
    _check_tables(tables, {"nodes": (torch.float32, 8),
                           "tris": (torch.float32, 12)}, dev)
    out = _outputs(n, dev)
    args = _Args(o=o.data_ptr(), d=d.data_ptr(),
                 nodes=tables["nodes"].data_ptr(),
                 tris=tables["tris"].data_ptr(),
                 **{k: x.data_ptr() for k, x in zip(("t", "u", "v", "idx"),
                                                    out)},
                 n=n, n_nodes=tables["nodes"].shape[0],
                 count_bits=tables["count_bits"],
                 shares=walk_shares(n, tables["count_bits"]))
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
    _check_tables(tables, {"top": (torch.float32, 8),
                           "nodes": (torch.float32, 8),
                           "tris": (torch.float32, 12),
                           "clusters": (torch.int32, 4)}, dev)
    out = _outputs(n, dev)
    args = _BigArgs(o=o.data_ptr(), d=d.data_ptr(),
                    **{k: tables[k].data_ptr() for k in (
                        "top", "nodes", "tris", "clusters")},
                    **{k: x.data_ptr() for k, x in zip(("t", "u", "v", "idx"),
                                                       out)},
                    n=n, n_top=tables["top"].shape[0],
                    count_bits=tables["count_bits"])
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


def pack_walk(scene: TorchScene) -> dict:
    """The tables of the walk :func:`two_level` picks for ``scene``, with
    ``big`` saying which (B4's when True, else B3's)."""
    big = two_level(scene)
    return dict((pack_big_tables if big else pack_tables)(scene), big=big)


def closest_tris(scene: TorchScene, walk: dict, o: torch.Tensor,
                 d: torch.Tensor):
    """Each ray's closest triangle from the walk ``walk`` packs
    (:func:`pack_walk`): B4 or B3 on CUDA tensors, their plain versions on
    CPU tensors."""
    fn = intersect_tris_big if walk["big"] else intersect_tris
    return fn(scene, walk, o, d)
