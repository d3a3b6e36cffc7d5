"""Each ray's closest sphere: kernel B6.

Replaces ``srt_tpu/pallas/spheres.py:_kernel`` (launched by
``sphere_winner_pallas``, ``spheres.py:60-177``). Two versions of the same
function:

* :func:`sphere_winner_reference`, the plain version
  (:func:`srt_tpu_torch.render.intersect.sphere_winner`): the chunked
  sweep, the first minimum on ties;
* ``csrc/sphere_winner.cu``, hand-written CUDA for ``sm_90a``: the (S, 12)
  sphere records of :func:`kernels.bounce.build_tables`, staged in shared
  memory, each tested by the bounce kernels' own ``sphere_t`` at the ray's
  time, so its winner is the sphere kernel B2 shaded, bit for bit; each
  ray's sweep split over G threads as B1's and B2's is (64 rays a block,
  G from :func:`kernels.bounce.sweep_shares`; the winner is the same at
  every G). It always lerps the centres, as the TPU kernel does
  (``spheres.py:150-154``): a static sphere's ``c0 + f * 0`` is ``c0``
  exactly.

:func:`sphere_winner` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back. Both return ``(t, idx)``:
``t`` float32, 3e38 on a miss, ``idx`` int32, -1 on a miss. The train
step's hybrid backward (:mod:`kernels.bounce_vjp`) takes its winner from
here and re-derives the hit differentiably.

Not carried over from the TPU kernel: the (rows, 128) planes, the one-hot
scalar fetches and its environment-variable opt-in (it lost to XLA's sweep
on the TPU); the caller passes B6's winner explicitly.
"""
from __future__ import annotations

import ctypes

import torch

from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels.build import launch
from srt_tpu_torch.render.intersect import \
    sphere_winner as sphere_winner_reference
from srt_tpu_torch.scene.ir import TorchScene

#: Kernel launches made by :func:`sphere_winner` (the CUDA path only).
LAUNCHES = 0

#: the most spheres a launch stages in shared memory (B2's table cap:
#: 4096 records of 48 bytes, 192 KiB of the 227 KiB a block may take)
MAX_SPHERES = 4096


class _Args(ctypes.Structure):
    """``SphereWinnerArgs`` of ``csrc/sphere_winner.cu``, field for
    field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "o", "d", "time", "sph", "t", "idx")]
        + [(name, ctypes.c_int) for name in ("n", "n_sph")]
        + [("t_min", ctypes.c_float), ("shares", ctypes.c_int)])


def kernel_args(sph: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                time: torch.Tensor, t_min: float) -> tuple[_Args, tuple]:
    """The checked arguments of one ``csrc/sphere_winner.cu`` launch and
    the outputs ``(t, idx)`` it writes."""
    dev, n = o.device, o.shape[0]
    for k, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                        ("time", time, (n,))):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape
                or x.device != dev or not x.is_contiguous()):
            raise ValueError(f"rays {k!r}: want contiguous float32 {shape} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    if (sph.dtype != torch.float32 or sph.dim() != 2 or sph.shape[1] != 12
            or sph.device != dev or not sph.is_contiguous()):
        raise ValueError(f"sphere table must be contiguous float32 (S, 12) "
                         f"on {dev}")
    if sph.shape[0] > MAX_SPHERES:
        raise ValueError(f"{sph.shape[0]} spheres: the kernel stages at most "
                         f"{MAX_SPHERES} in shared memory")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    args = _Args(o=o.data_ptr(), d=d.data_ptr(), time=time.data_ptr(),
                 sph=sph.data_ptr(), t=t.data_ptr(), idx=idx.data_ptr(),
                 n=n, n_sph=sph.shape[0], t_min=float(t_min),
                 shares=kb.sweep_shares(n, sph.shape[0]))
    return args, (t, idx)


def sphere_winner(scene: TorchScene, sph: torch.Tensor, o: torch.Tensor,
                  d: torch.Tensor, time: torch.Tensor, t_min: float = 1e-3):
    """Each ray's closest sphere ``(t, idx)`` at its ``time``: the plain
    version for CPU tensors, kernel B6 for CUDA tensors. ``sph`` is
    :func:`kernels.bounce.build_tables`' ``"sph"`` table of ``scene``."""
    global LAUNCHES
    if o.device.type == "cpu":
        return sphere_winner_reference(scene, o, d, time, t_min)
    if o.device.type != "cuda":
        raise ValueError(f"no sphere kernel for {o.device}")
    args, out = kernel_args(sph, o, d, time, t_min)
    launch("srt_sphere_winner", args, o.device)
    LAUNCHES += 1
    return out
