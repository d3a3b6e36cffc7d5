"""Rays a second of the sharded render against the number of processes
(counterpart of ``tools/scaling.py``).

For each count N of ``--devices`` the sweep starts N processes, joined by
:func:`dist.multihost.init_multihost` through a file in its work
directory, and each renders its strip of pixels
(:func:`dist.sharding.render_sharded`, scene replicated, image gathered).
A first render warms up (and builds the kernels), then ``--reps`` renders
of other seeds are timed on process 0's clock, each render ending in the
gather that waits for every process. "Devices" are processes: with
``--device cuda`` each takes the card of its rank modulo the cards there
are, so N processes share ``min(N, cards)`` cards; the backend is NCCL
when every process has a card of its own and gloo when they share one
(NCCL refuses two ranks on one card). On the CPU each process takes one
thread. One process renders without a process group.

Usage::

    python -m srt_tpu_torch.dist.scaling [--scene cornell_boxes]
        [--width 128] [--spp 8] [--max-depth 8] [--reps 3]
        [--devices 1 2 4] [--device cuda] [--work-dir DIR] [--timeout 600]

Prints one JSON line with the JAX tool's keys (``metric``
``scaling_rays_per_sec``, and per count ``rays_per_sec``, ``wall_s``,
``efficiency_vs_linear`` and, from the second count on,
``bit_exact_vs_1dev``: the warm-up image equal to the first count's to
the bit), and ``backend`` and ``cards``: the process group's backend at
the largest count and the cards the processes ran on (0 on the CPU), so
that a sweep of processes sharing one card is never read as scaling.
The work directory, a temporary one unless ``--work-dir`` names one,
holds each count's image as ``img<N>.npy``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="srt_tpu_torch.dist.scaling",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="cornell_boxes")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="process counts to sweep (default: 1, 2, 4, ... "
                         "up to the cards there are, or 1 on the CPU)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device type of every process")
    ap.add_argument("--work-dir", default=None,
                    help="rendezvous files and images (default: a "
                         "temporary directory, removed at the end)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each count's processes may take")
    return ap.parse_args(argv)


def _worker(rank: int, world: int, work: str, backend: str | None,
            args: dict) -> None:
    """One process of a count: join, warm up, time the renders; rank 0
    saves the warm-up image and the seconds a render."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from srt_tpu_torch.dist.multihost import global_mesh, init_multihost
    from srt_tpu_torch.dist.sharding import render_sharded
    from srt_tpu_torch.render.api import RenderConfig
    from srt_tpu_torch.scene.library import get_scene

    if args["device"] == "cpu":
        torch.set_num_threads(1)
    init_multihost("file://" + os.path.join(work, f"pg{world}"), world,
                   rank, backend, args["device"])
    try:
        mesh = global_mesh(args["device"])
        scene, camera, _ = get_scene(args["scene"], aspect=1.0,
                                     device=mesh.device)
        w = args["width"]
        cfg = RenderConfig(width=w, height=w, spp=args["spp"],
                           max_depth=args["max_depth"], rr_start=1 << 30,
                           sample_chunk=args["spp"])

        def sync():
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)

        img = render_sharded(scene, camera, cfg, mesh)
        sync()
        t0 = time.perf_counter()
        for r in range(args["reps"]):
            render_sharded(scene, camera, dataclasses.replace(cfg, seed=r + 1),
                           mesh)
        sync()
        wall = (time.perf_counter() - t0) / args["reps"]
        if rank == 0:
            np.save(os.path.join(work, f"img{world}.npy"), img.cpu().numpy())
            with open(os.path.join(work, f"wall{world}.json"), "w") as f:
                json.dump({"wall_s": wall, "backend": mesh.backend}, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_count(fn, world: int, work: str, backend, args: dict,
               timeout: float) -> None:
    """``fn`` in ``world`` spawned processes, joined within ``timeout``
    seconds; a process still running then is killed and the sweep
    fails."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world, work, backend, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} processes did not end in "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def run(args: argparse.Namespace) -> dict:
    """Sweep the counts as the arguments say; returns the JSON record."""
    import numpy as np
    import torch

    from srt_tpu_torch.dist import scaling    # spawn pickles by module

    cuda = args.device.startswith("cuda")
    cards = torch.cuda.device_count() if cuda else 0
    counts = args.devices
    if counts is None:
        counts, c = [], 1
        while c <= max(cards, 1):
            counts.append(c)
            c *= 2
    work = args.work_dir or tempfile.mkdtemp(prefix="srt_scaling_")
    os.makedirs(work, exist_ok=True)
    wargs = dict(scene=args.scene, width=args.width, spp=args.spp,
                 max_depth=args.max_depth, reps=args.reps,
                 device=args.device)
    primary = args.width * args.width * args.spp
    rows, img1, backend = {}, None, None
    try:
        for c in counts:
            be = None if c == 1 else (
                "nccl" if cuda and cards >= c else "gloo")
            _run_count(scaling._worker, c, work, be, wargs, args.timeout)
            img = np.load(os.path.join(work, f"img{c}.npy"))
            with open(os.path.join(work, f"wall{c}.json")) as f:
                rec = json.load(f)
            backend = rec["backend"]
            rows[c] = {"rays_per_sec": primary / rec["wall_s"],
                       "wall_s": rec["wall_s"]}
            if img1 is None:
                img1 = img
            else:    # every random decision is a pure function of its ids
                rows[c]["bit_exact_vs_1dev"] = bool(np.array_equal(
                    img1.view(np.int32), img.view(np.int32)))
            print(f"[scaling] {c} processes ({backend or 'no group'}): "
                  f"{rows[c]}", file=sys.stderr, flush=True)
    finally:
        if args.work_dir is None:
            shutil.rmtree(work, ignore_errors=True)
    base = rows[counts[0]]["rays_per_sec"] / counts[0]
    for c in counts:
        rows[c]["efficiency_vs_linear"] = rows[c]["rays_per_sec"] / (base * c)
    return {"metric": "scaling_rays_per_sec", "scene": args.scene,
            "width": args.width, "spp": args.spp,
            "platform": "gpu" if cuda else "cpu",
            "devices": rows, "backend": backend,
            "cards": min(cards, max(counts))}


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
