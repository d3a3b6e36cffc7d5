"""The material sum of the train backward: kernel B5's per-lane material
cotangents summed by material into the (M, 14) table
(``csrc/segment_sum.cu``).

Replaces no TPU kernel: the JAX package sums B5's outputs after its
backward kernel with XLA's scatter (``srt_tpu/pallas/bounce_bwd.py:
308-315``, ``.at[mid].add``). Two versions of the same function:

* :func:`material_sum_reference`, the plain version: ``index_add_`` into
  the (M, 10) sums, placed in the table's differentiable columns
  (``kernels/bounce.py:MAT_GRAD_COLS``). On the
  CPU it adds lane after lane (the bits of JAX's ``.at[].add`` on the
  CPU); on the card its float atomics add in an order the scheduler picks
  (ROADMAP C18);
* ``csrc/segment_sum.cu``: one launch that sums each material's lanes in
  a fixed order (lanes within 32-lane chunks, chunks within a warp, warps
  within a block, then the blocks strided over a warp's lanes and met in a
  butterfly: see the source), so its bits repeat run to run. The order
  differs from the plain version's, so the two agree to rounding, under
  the gradient contract (``utils/contract.py:check_grads``), not to the
  bit. :func:`material_sum_order` is that order in torch, which no path
  calls: the tests hold the kernel to it to the bit (adds round the same
  on the card and the CPU).

:func:`material_sum` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from srt_tpu_torch import trace as tracer
from srt_tpu_torch.kernels.bounce import MAT_GRAD_COLS
from srt_tpu_torch.kernels.build import launch

#: the kernel's column map holds up to this many inputs
MAX_COLS = 16
#: the material table's width (``kernels/bounce.py:build_tables``)
TABLE_COLS = 14
#: shared memory a block may take (227 KiB); the kernel holds each warp's
#: (M, K) sums, its staged chunk (32, K + 1) and its chunk's 32 materials
#: and their lanes
SMEM_BYTES = 232_448
#: the kernel's warps a block, lanes a chunk, most chunks a warp, and the
#: blocks its chunk count aims to fill (``csrc/segment_sum.cu``)
WARPS, CHUNK, MAX_CHUNKS, FILL = 8, 32, 8, 128

#: (device, stream) -> the kernel's arrival counter (never reset: a
#: launch adds a whole span) and its scratch of block sums, grown to the
#: largest launch; one a stream, so that launches on two streams never
#: share them
_SCRATCH = {}


class _Args(ctypes.Structure):
    """``SegmentSumArgs`` of ``csrc/segment_sum.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "g", "seg", "part", "out", "done")]
        + [(name, ctypes.c_int) for name in ("n", "k", "m", "out_cols")]
        + [("col", ctypes.c_int * MAX_COLS)])


def chunks_for(n: int, fill: int = FILL) -> int:
    """The kernel's 32-lane chunks a warp at ``n`` lanes: one, or as many
    as keep ``fill`` blocks busy, at most ``MAX_CHUNKS``."""
    return min(max(n // (fill * WARPS * CHUNK), 1), MAX_CHUNKS)


def blocks_for(n: int, fill: int = FILL) -> int:
    """The kernel's blocks at ``n`` lanes."""
    window = WARPS * CHUNK * chunks_for(n, fill)
    return -(-n // window)


def material_sum_reference(g: torch.Tensor, seg: torch.Tensor,
                           n_mat: int) -> torch.Tensor:
    """Plain version: the rows of ``g`` (N, 10) summed by ``seg`` (N,)
    into (``n_mat``, 10), placed in the table's differentiable columns
    (``MAT_GRAD_COLS``) of an (``n_mat``, 14) table of zeros."""
    per_mat = torch.zeros((n_mat, g.shape[1]), dtype=g.dtype,
                          device=g.device)
    per_mat.index_add_(0, seg.long(), g)
    out = torch.zeros((n_mat, TABLE_COLS), dtype=g.dtype, device=g.device)
    out[:, list(MAT_GRAD_COLS)] = per_mat
    return out


def material_sum_order(g: torch.Tensor, seg: torch.Tensor, n_mat: int,
                       fill: int = FILL) -> torch.Tensor:
    """The kernel's order of adds in torch, one float32 add at a time, on
    any device; no path calls it. ``fill`` is the kernel's ``kFill``."""
    n, k = g.shape
    chunks = chunks_for(n, fill)
    blocks = blocks_for(n, fill)
    lanes = blocks * WARPS * chunks * CHUNK
    ids = torch.full((lanes,), n_mat, dtype=torch.long, device=g.device)
    ids[:n] = seg.long()
    vals = torch.zeros((lanes, k), dtype=g.dtype, device=g.device)
    vals[:n] = g
    n_chunks = lanes // CHUNK
    ids = ids.view(n_chunks, CHUNK)
    vals = vals.view(n_chunks, CHUNK, k)
    rows = torch.arange(n_chunks, device=g.device)
    # 1. each chunk: a material's lanes in lane order, from 0 (the extra
    #    row n_mat takes the lanes past n)
    cs = torch.zeros((n_chunks, n_mat + 1, k), dtype=g.dtype,
                     device=g.device)
    present = torch.zeros((n_chunks, n_mat + 1), dtype=torch.bool,
                          device=g.device)
    for j in range(CHUNK):
        cs[rows, ids[:, j]] = cs[rows, ids[:, j]] + vals[:, j]
        present[rows, ids[:, j]] = True
    cs = cs[:, :n_mat].view(blocks * WARPS, chunks, n_mat, k)
    present = present[:, :n_mat].view(blocks * WARPS, chunks, n_mat, 1)
    # 2. each warp: its chunks in order, from 0, where the material is
    warp = torch.zeros((blocks * WARPS, n_mat, k), dtype=g.dtype,
                       device=g.device)
    for q in range(chunks):
        warp = torch.where(present[:, q], warp + cs[:, q], warp)
    # 3. each block: its warps in order
    warp = warp.view(blocks, WARPS, n_mat, k)
    part = warp[:, 0]
    for w in range(1, WARPS):
        part = part + warp[:, w]
    # 4. lane j of a warp: blocks j, j + 32, ... in order, from 0; then the
    #    butterfly
    lane = torch.zeros((CHUNK, n_mat, k), dtype=g.dtype, device=g.device)
    for b0 in range(0, blocks, CHUNK):
        m = min(CHUNK, blocks - b0)
        lane[:m] = lane[:m] + part[b0:b0 + m]
    idx = torch.arange(CHUNK, device=g.device)
    for o in (16, 8, 4, 2, 1):
        lane = lane + lane[idx ^ o]
    out = torch.zeros((n_mat, TABLE_COLS), dtype=g.dtype, device=g.device)
    out[:, list(MAT_GRAD_COLS)] = lane[0]
    return out


def scratch(dev: torch.device, blocks: int, n_mat: int, k: int) -> tuple:
    """The arrival counter and a block-sums buffer of at least ``blocks``
    x ``n_mat`` x ``k`` floats for launches on ``dev``'s current stream."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    done, part = _SCRATCH.get(key, (None, None))
    if done is None:
        done = torch.zeros((1,), dtype=torch.int32, device=dev)
    size = blocks * n_mat * k
    if part is None or part.numel() < size:
        part = torch.empty((size,), dtype=torch.float32, device=dev)
    _SCRATCH[key] = (done, part)
    return done, part


def kernel_args(g: torch.Tensor, seg: torch.Tensor,
                n_mat: int) -> tuple[_Args, torch.Tensor]:
    """The checked arguments of one ``csrc/segment_sum.cu`` launch and the
    table it writes."""
    dev = g.device
    n, k = g.shape
    if (g.dtype != torch.float32 or k != len(MAT_GRAD_COLS)
            or not g.is_contiguous() or seg.dtype != torch.int32
            or tuple(seg.shape) != (n,) or seg.device != dev
            or not seg.is_contiguous()):
        raise ValueError(f"material sum: want contiguous float32 (N, "
                         f"{len(MAT_GRAD_COLS)}) values and int32 (N,) ids "
                         f"on {dev}")
    if 4 * WARPS * (n_mat * k + CHUNK * (k + 1) + 2 * CHUNK) > SMEM_BYTES:
        raise ValueError(f"material sum: {n_mat} x {k} sums exceed a "
                         f"block's shared memory")
    done, part = scratch(dev, blocks_for(n), n_mat, k)
    out = torch.empty((n_mat, TABLE_COLS), dtype=torch.float32, device=dev)
    args = _Args(g=g.data_ptr(), seg=seg.data_ptr(), part=part.data_ptr(),
                 out=out.data_ptr(), done=done.data_ptr(), n=n, k=k,
                 m=n_mat, out_cols=TABLE_COLS,
                 col=(ctypes.c_int * MAX_COLS)(*MAT_GRAD_COLS))
    return args, out


def material_sum(g: torch.Tensor, seg: torch.Tensor,
                 n_mat: int) -> torch.Tensor:
    """B5's per-lane material cotangents ``g`` (N, 10) summed by material
    ``seg`` (N,) int32 into the (``n_mat``, 14) table's differentiable
    columns, zeros elsewhere: the plain version for CPU tensors, the
    kernel for CUDA tensors; a ``segment_sum`` launch span with its lanes
    where the call records."""
    on = tracer.ON
    t0 = tracer.now() if on else 0
    if g.device.type == "cpu":
        out = material_sum_reference(g, seg, n_mat)
    elif g.device.type == "cuda":
        args, out = kernel_args(g, seg, n_mat)
        launch("srt_segment_sum", args, g.device)
        tracer.COUNTS["segment_sum"] += 1
    else:
        raise ValueError(f"no material-sum kernel for {g.device}")
    if on:
        tracer.launch("segment_sum", t0, g.shape[0])
    return out
