"""The regeneration engine's film: finished lanes' radiance added into the
image in lane order (``csrc/film_sum.cu``), with the vertex and NaN
counts.

Replaces no TPU kernel: the JAX package adds the finished lanes after its
bounce kernel with XLA's scatter (``srt_tpu/render/regen.py:108-122``,
``acc.at[pix].add(contrib)``). Two versions of the same function:

* :func:`film_sum_reference`, the plain version: the finished lanes'
  radiance, NaN scrubbed, added with ``index_add_``, which on the CPU adds
  lane after lane (the bits of JAX's ``.at[].add`` on the CPU; on the card
  its float atomics add in an order the scheduler picks, ROADMAP C18);
* ``csrc/film_sum.cu``: one cooperative launch that packs each pixel's
  finished lanes, tile by tile, into records registered with the pixel,
  and adds the records in tile order, each one's lanes in lane order,
  from the pixel's sum; it counts the live lanes and the scrubbed NaN
  components. Its sums are the plain version's on the CPU, bit for bit,
  in every run.

:class:`Film` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back. The lanes come in B1's
planes: ``fin`` (finished in this bounce) and ``alive`` (after it), (N,)
int32 each; a lane is live if alive or finished. The per-bounce loop
builds the same planes from its bool masks.
"""
from __future__ import annotations

import ctypes

import torch

from srt_tpu_torch import trace as tracer
from srt_tpu_torch.kernels.build import launch, load_library


class _Args(ctypes.Structure):
    """``FilmSumArgs`` of ``csrc/film_sum.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "acc", "pix", "rad", "fin", "alive", "meta", "bits", "table",
        "packed", "barrier", "n_vertices", "nan_scrubbed")]
        + [(name, ctypes.c_int) for name in ("n", "pixels", "words")])


def film_sum_reference(acc: torch.Tensor, n_vertices: torch.Tensor,
                       nan_scrubbed: torch.Tensor, pix: torch.Tensor,
                       radiance: torch.Tensor, fin: torch.Tensor,
                       alive: torch.Tensor) -> None:
    """Plain version, in place: the finished lanes' radiance (3, N) added
    at their pixels into ``acc`` (3, pixels), NaN scrubbed and counted
    (de_nan, ``Raytracing_n.cpp:47-53``); the live lanes (alive or
    finished) added to ``n_vertices`` as traced path vertices."""
    done = fin != 0
    contrib = torch.where(done, radiance, 0.0)
    is_nan = torch.isnan(contrib)
    acc.index_add_(1, pix, torch.where(is_nan, 0.0, contrib))
    n_vertices += ((alive != 0) | done).sum()
    nan_scrubbed += is_nan.sum()


class Film:
    """The image sums (3, pixels) and the counters, on the device; on the
    card also the kernel's scratch: each pixel's row (the count of its
    records, 0 between launches, and the first seven records) and bitmap
    of tiles (0 between launches), each tile's hash table of records, the
    records' packed radiance and the grid barrier's counter; 64 bytes a
    pixel at a 65,536-lane wavefront. ``plain`` takes the plain version on
    any device (how ``render_regen(plain=True)`` checks the kernels' image
    on the card)."""

    def __init__(self, pixels: int, lanes: int, device, plain: bool = False):
        device = torch.device(device)
        self.plain = plain or device.type == "cpu"
        self.acc = torch.zeros((3, pixels), dtype=torch.float32,
                               device=device)
        self.n_vertices = torch.zeros((), dtype=torch.int64, device=device)
        self.nan_scrubbed = torch.zeros((), dtype=torch.int64, device=device)
        if not self.plain:
            if device.type != "cuda":
                raise ValueError(f"no film kernel for {device}")
            lib = load_library()
            words = lib.srt_film_sum_words(lanes)
            tiles = -(-lanes // lib.srt_film_sum_tile())
            self.meta = torch.zeros((pixels, 8), dtype=torch.int32,
                                    device=device)
            self.bits = torch.zeros((pixels, words), dtype=torch.int32,
                                    device=device)
            self.table = torch.empty((tiles, lib.srt_film_sum_slots(), 2),
                                     dtype=torch.int32, device=device)
            self.packed = torch.empty((lanes, 3), dtype=torch.float32,
                                      device=device)
            self.barrier = torch.zeros((1,), dtype=torch.int32,
                                       device=device)

    def flush(self, pix: torch.Tensor, radiance: torch.Tensor,
              fin: torch.Tensor, alive: torch.Tensor) -> None:
        """Add the finished lanes' radiance (3, N) at their pixels ``pix``
        (N,) and count, with B1's planes ``fin`` and ``alive``: the plain
        version for CPU tensors (or a film made ``plain``), the kernel for
        CUDA tensors; a ``film_sum`` launch span with its lanes where the
        call records."""
        on = tracer.ON
        t0 = tracer.now() if on else 0
        if self.plain:
            film_sum_reference(self.acc, self.n_vertices, self.nan_scrubbed,
                               pix, radiance, fin, alive)
        else:
            launch("srt_film_sum",
                   self.kernel_args(pix, radiance, fin, alive),
                   self.acc.device)
            tracer.COUNTS["film_sum"] += 1
        if on:
            tracer.launch("film_sum", t0, pix.shape[0])

    def clean(self) -> bool:
        """Whether the kernel's per-pixel scratch is as a launch must find
        it: every row's count and every bitmap word 0."""
        return not (int(self.meta[:, 0].count_nonzero())
                    or int(self.bits.count_nonzero()))

    def kernel_args(self, pix, radiance, fin, alive) -> _Args:
        """The checked arguments of one ``csrc/film_sum.cu`` launch."""
        dev, n = self.acc.device, pix.shape[0]
        for name, x in (("pixels", pix), ("fin", fin), ("alive", alive)):
            if (x.dtype != torch.int32 or tuple(x.shape) != (n,)
                    or x.device != dev or not x.is_contiguous()):
                raise ValueError(f"film {name}: want contiguous int32 ({n},)"
                                 f" on {dev}")
        if (radiance.dtype != torch.float32 or tuple(radiance.shape) != (3, n)
                or radiance.device != dev or not radiance.is_contiguous()):
            raise ValueError(f"film radiance: want contiguous float32 "
                             f"(3, {n}) on {dev}")
        if n > self.packed.shape[0]:
            raise ValueError(f"{n} lanes: the film holds scratch for "
                             f"{self.packed.shape[0]}")
        return _Args(
            acc=self.acc.data_ptr(), pix=pix.data_ptr(),
            rad=radiance.data_ptr(), fin=fin.data_ptr(),
            alive=alive.data_ptr(), meta=self.meta.data_ptr(),
            bits=self.bits.data_ptr(), table=self.table.data_ptr(),
            packed=self.packed.data_ptr(),
            barrier=self.barrier.data_ptr(),
            n_vertices=self.n_vertices.data_ptr(),
            nan_scrubbed=self.nan_scrubbed.data_ptr(), n=n,
            pixels=self.acc.shape[1], words=self.bits.shape[1])
