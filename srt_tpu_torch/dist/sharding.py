"""Rendering with the pixel axis split over processes (counterpart of
``srt_tpu/dist/sharding.py``), on ``torch.distributed``.

The JAX package shards the ray wavefront over the devices of a 1-D
``Mesh`` with ``shard_map``; here one process drives one device, and the
mesh is the process group. Its design is the JAX package's:

* the **pixel axis** is the data-parallel axis: pixel ids are padded to a
  multiple of the world size, and each rank renders one contiguous strip
  through the scan engine's own sum (:func:`render.api.accumulate`);
* the **scene is replicated**: :func:`replicate_scene` broadcasts every
  table from rank 0;
* the only communication is the image's assembly (an all-gather of the
  strips) and, in training, the mean of the loss and the gradients
  (:func:`pmean`, JAX's ``pmean``).

A rank's pixels do not depend on the others: every random decision is a
pure function of (seed, pixel, sample, bounce, dimension), and each
pixel's sample chunks are summed in order by the one function that
:func:`render.api.render` sums with. So one rank and N ranks give the same image to the bit.

The collectives take the ranks' tensors where they lie: ``nccl`` on the
card, ``gloo`` on the CPU or on the card (it stages a card's tensors
through the host itself), so several processes can share one card, which
NCCL refuses.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from srt_tpu_torch.render.api import accumulate, render_setup
from srt_tpu_torch.scene.ir import TorchScene


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The counterpart of JAX's 1-D device ``Mesh``: the ``size``
    processes of the default group (or one process without a group),
    this process's ``rank`` and the ``device`` it renders on."""
    size: int
    rank: int
    device: torch.device

    @property
    def backend(self) -> str | None:
        """``"nccl"``, ``"gloo"``, or None for one process without a
        process group."""
        if not dist.is_initialized():
            return None
        return dist.get_backend()


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh over every process of the default group (JAX's
    ``make_mesh``; one process per device), or a one-process mesh when no
    process group is initialised. ``n_devices``, when given, must be that
    world size. ``device``: the process's device, ``cuda`` (the card of
    index ``rank`` modulo the cards visible) unless the caller names
    another, whatever the group's backend."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs as many "
                         f"processes; the world has {size}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda",
                              rank % max(torch.cuda.device_count(), 1))
    return Mesh(size, rank, device)


def same_device(device, mesh_device: torch.device) -> bool:
    """Whether ``device`` names ``mesh_device``: the same type, and the
    same index where ``device`` gives one (``"cuda"`` names any card)."""
    device = torch.device(device)
    return device.type == mesh_device.type and (
        device.index is None or device.index == mesh_device.index)


def broadcast(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank, as a new tensor."""
    if mesh.size == 1:
        return t
    x = t.detach().contiguous().clone()
    view = x.view(torch.uint8) if x.dtype == torch.bool else x
    dist.broadcast(view, src=0)
    return x


def pmean(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the mesh's ranks (JAX's ``lax.pmean``)."""
    if mesh.size == 1:
        return t
    x = t.detach().contiguous().clone()
    dist.all_reduce(x)
    return x / mesh.size


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) stacked along a new first
    axis in rank order."""
    if mesh.size == 1:
        return t[None]
    x = t.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.stack(parts)


def replicate_scene(scene: TorchScene, mesh: Mesh) -> TorchScene:
    """Rank 0's scene on every rank, on the rank's device: every table
    broadcast from rank 0 (JAX's ``replicate_scene`` puts every buffer
    fully replicated on the mesh)."""
    return dataclasses.replace(scene, **{
        f.name: broadcast(mesh, getattr(scene, f.name).to(mesh.device))
        for f in dataclasses.fields(TorchScene)
        if getattr(scene, f.name) is not None})


def strip(mesh: Mesh, n_pixels: int) -> tuple[int, int]:
    """This rank's pixel ids ``[lo, hi)``: the pixel axis padded to a
    multiple of the world size (``sharding.py:60-68``), in contiguous
    strips; ids past ``n_pixels`` are padding."""
    per = math.ceil(n_pixels / mesh.size)
    return mesh.rank * per, (mesh.rank + 1) * per


def render_sharded(scene: TorchScene, camera, config,
                   mesh: Mesh) -> torch.Tensor:
    """Render (H, W, 3) with the pixel axis split over ``mesh``, every
    rank returning the whole image (``sharding.py:47-89``). The scene and
    camera are broadcast from rank 0 onto each rank's device; each rank
    sums its strip with :func:`render.api.accumulate`, as
    :func:`render.api.render` does, and the strips are gathered."""
    scene = replicate_scene(scene, mesh)
    camera = type(camera)(*(broadcast(mesh, t.to(mesh.device))
                            for t in camera))
    _, jitter, route = render_setup(scene, config)
    n_pixels = config.width * config.height
    acc, _ = accumulate(route, camera, config, jitter,
                        pixels=strip(mesh, n_pixels))
    img = all_gather(mesh, acc).reshape(-1, 3)[:n_pixels]
    return (img / config.spp).reshape(config.height, config.width, 3)
