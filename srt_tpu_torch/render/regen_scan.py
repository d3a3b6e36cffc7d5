"""Reverse-differentiable path regeneration: a persistent wavefront driven
for a static number of steps (counterpart of
``srt_tpu/render/regen_scan.py``).

The forward engine (:mod:`srt_tpu_torch.render.regen`) stops when its work
queue drains, which the host learns by reading the device. This engine
runs ``n_steps`` substeps, a number fixed in advance
(:func:`steps_for`), so the whole trace is one autograd tape and the
host never waits on the device. Each substep regenerates dead lanes from
the queue of primary rays (``torch.cumsum`` ranks), takes one
differentiable bounce (:func:`kernels.bounce_vjp.bounce_step_auto`: kernel
B2 forward; kernel B5 backward, or the hybrid backward for geometry
gradients and the scenes B5 does not cover) and emits the paths that
finished. Paths
that exhaust the budget are truncated: their partial radiance is flushed
at the end, the same contract as a depth cap.

The JAX engine's ``checkpoint`` and ``unroll`` are ``lax.scan`` knobs
with no counterpart: the tape already keeps only what ``BounceCore`` and
``BounceHybrid`` save, each bounce's inputs.
"""
from __future__ import annotations

import torch

from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.kernels.bounce import StepSpec
from srt_tpu_torch.kernels.bounce_vjp import bounce_step_auto
from srt_tpu_torch.scene.ir import SceneFlags, TorchScene

_F32 = torch.float32


def trace_queue(scene: TorchScene, flags: SceneFlags, tables: dict, rays,
                salts: torch.Tensor, *, n_steps: int, wavefront: int,
                spec: StepSpec):
    """Trace a queue of N primary rays ``(origin (N,3), direction (N,3),
    time (N,))`` with sampler salts (N,) int32 -> ``((N, 3) radiance,
    (N,) started)``. ``started`` is 1.0 for rays the budget reached (a
    path cut by the budget still counts, with its partial radiance), 0.0
    for rays never started. The bounce takes the backward kernel when no
    geometric tensor of the scene requires a gradient
    (``regen_scan.py:118-125``)."""
    origin, direction, ray_time = rays
    n = origin.shape[0]
    m = min(wavefront, n)
    dev = origin.device
    zeros3 = torch.zeros((m, 3), dtype=_F32, device=dev)
    d0 = zeros3.clone()
    d0[:, 2] = 1.0
    st = dict(o=zeros3, d=d0, time=torch.zeros((m,), dtype=_F32, device=dev),
              beta=zeros3, radiance=zeros3,
              alive=torch.zeros((m,), dtype=torch.bool, device=dev),
              salt=torch.zeros((m,), dtype=torch.int32, device=dev),
              depth=torch.zeros((m,), dtype=torch.int32, device=dev))
    cursor = torch.zeros((), dtype=torch.int64, device=dev)
    rid = torch.zeros((m,), dtype=torch.int64, device=dev)
    rids, contribs, started_ids = [], [], []
    walk = ki.pack_walk(scene) if scene.n_tris else None

    for _ in range(n_steps):
        # regenerate dead lanes from the queue (regen_scan.py:88-111)
        need = ~st["alive"]
        wid = cursor + torch.cumsum(need, 0) - 1
        take = need & (wid < n)
        src = torch.clamp(wid, 0, n - 1)
        rid = torch.where(take, src, rid)
        cursor = cursor + take.sum()
        t3 = take[:, None]
        st = dict(o=torch.where(t3, origin[src], st["o"]),
                  d=torch.where(t3, direction[src], st["d"]),
                  time=torch.where(take, ray_time[src], st["time"]),
                  beta=torch.where(t3, 1.0, st["beta"]),
                  radiance=torch.where(t3, 0.0, st["radiance"]),
                  alive=st["alive"] | take,
                  salt=torch.where(take, salts[src], st["salt"]),
                  depth=torch.where(take, 0, st["depth"]))
        started_ids.append(torch.where(take, src, n))

        # one bounce, then the depth cap (regen_scan.py:113-126)
        was_alive = st["alive"]
        nxt = bounce_step_auto(scene, flags, tables, st, spec, walk)
        alive = nxt["alive"] & (nxt["depth"] < spec.max_depth)

        # finished paths, NaN-scrubbed, scattered once at the end
        contrib = torch.where((was_alive & ~alive)[:, None],
                              nxt["radiance"], 0.0)
        contribs.append(torch.where(torch.isnan(contrib), 0.0, contrib))
        rids.append(rid)
        st = dict(nxt, alive=alive)

    tail = torch.where(st["alive"][:, None], st["radiance"], 0.0)
    contribs.append(torch.where(torch.isnan(tail), 0.0, tail))
    rids.append(rid)
    out = torch.zeros((n, 3), dtype=_F32, device=dev).index_add(
        0, torch.cat(rids), torch.cat(contribs))
    started = torch.zeros((n + 1,), dtype=_F32, device=dev)
    if started_ids:
        ids = torch.cat(started_ids)
        started.index_add_(0, ids, torch.ones_like(ids, dtype=_F32))
    return out, started[:n]


def steps_for(n_rays: int, wavefront: int, depth_budget: float,
              max_depth: int, drain: int | None = None) -> int:
    """Static step budget: queue-drain steps at the expected mean path
    length plus a ``drain`` tail for the last wavefront's stragglers
    (``drain=None``: the bias-free full ``max_depth`` tail)."""
    m = min(wavefront, n_rays)
    tail = max_depth if drain is None else min(drain, max_depth)
    return int(-(-int(n_rays * depth_budget) // m)) + tail
