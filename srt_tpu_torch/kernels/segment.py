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
  a fixed order (lanes within 32-lane chunks, chunks, warps, blocks: see
  the source), so its bits repeat run to run. The order differs from the
  plain version's, so the two agree to rounding, under the gradient
  contract (``utils/contract.py:check_grads``), not to the bit.

:func:`material_sum` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from srt_tpu_torch.kernels.bounce import MAT_GRAD_COLS
from srt_tpu_torch.kernels.build import launch, load_library

#: Kernel launches made by :func:`material_sum` (the CUDA path only).
LAUNCHES = 0

#: the kernel's column map holds up to this many inputs
MAX_COLS = 16
#: the material table's width (``kernels/bounce.py:build_tables``)
TABLE_COLS = 14
#: shared memory a block may take (227 KiB); the kernel holds 8 warps'
#: (M, K) float sums
SMEM_BYTES = 232_448

#: (device, stream) -> the kernel's counter of finished blocks, which the
#: kernel sets back to 0 (a fresh one a launch would cost a fill launch a
#: bounce on a host-paced loop); one a stream, so that launches on two
#: streams never share one, and set to 0 from the host when a launch raises
_DONE = {}


class _Args(ctypes.Structure):
    """``SegmentSumArgs`` of ``csrc/segment_sum.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "g", "seg", "part", "out", "done")]
        + [(name, ctypes.c_int) for name in ("n", "k", "m", "out_cols")]
        + [("col", ctypes.c_int * MAX_COLS)])


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


def done_counter(dev: torch.device) -> torch.Tensor:
    """The finished-blocks counter of launches on ``dev``'s current
    stream."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _DONE:
        _DONE[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return _DONE[key]


def kernel_args(g: torch.Tensor, seg: torch.Tensor,
                n_mat: int) -> tuple[_Args, torch.Tensor, torch.Tensor]:
    """The checked arguments of one ``csrc/segment_sum.cu`` launch, the
    table it writes and its scratch of block sums."""
    dev = g.device
    n, k = g.shape
    if (g.dtype != torch.float32 or k != len(MAT_GRAD_COLS)
            or not g.is_contiguous() or seg.dtype != torch.int32
            or tuple(seg.shape) != (n,) or seg.device != dev
            or not seg.is_contiguous()):
        raise ValueError(f"material sum: want contiguous float32 (N, "
                         f"{len(MAT_GRAD_COLS)}) values and int32 (N,) ids "
                         f"on {dev}")
    if 8 * n_mat * k * 4 > SMEM_BYTES:
        raise ValueError(f"material sum: {n_mat} x {k} sums exceed a "
                         f"block's shared memory")
    blocks = load_library().srt_segment_sum_blocks(n)
    part = torch.empty((blocks, n_mat, k), dtype=torch.float32, device=dev)
    out = torch.empty((n_mat, TABLE_COLS), dtype=torch.float32, device=dev)
    args = _Args(g=g.data_ptr(), seg=seg.data_ptr(), part=part.data_ptr(),
                 out=out.data_ptr(), done=done_counter(dev).data_ptr(), n=n,
                 k=k,
                 m=n_mat, out_cols=TABLE_COLS,
                 col=(ctypes.c_int * MAX_COLS)(*MAT_GRAD_COLS))
    return args, out, part


def material_sum(g: torch.Tensor, seg: torch.Tensor,
                 n_mat: int) -> torch.Tensor:
    """B5's per-lane material cotangents ``g`` (N, 10) summed by material
    ``seg`` (N,) int32 into the (``n_mat``, 14) table's differentiable
    columns, zeros elsewhere: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    global LAUNCHES
    if g.device.type == "cpu":
        return material_sum_reference(g, seg, n_mat)
    if g.device.type != "cuda":
        raise ValueError(f"no material-sum kernel for {g.device}")
    args, out, _part = kernel_args(g, seg, n_mat)
    try:
        launch("srt_segment_sum", args, g.device)
    except RuntimeError:
        done_counter(g.device).zero_()   # the next launch counts from 0
        raise
    LAUNCHES += 1
    return out
