"""Command-line renderer: ``python -m srt_tpu_torch --scene cornell ...``
(counterpart of ``srt_tpu/cli.py``).

The same flags, defaults and output as the JAX package's command line:
parse the command, build the scene, render it with either engine (or
checkpoint and resume), tonemap, write a PNG or the reference's ASCII
``P3`` PPM by the output's extension, and print one human line to stderr
and, under ``--metrics``, one JSON line with the JAX line's keys and
``launches``, the render's launches of each kernel read from the kernels'
counters (:func:`kernels.launch_counts`). It runs on the card unless
``--device`` names another torch device. ``--sphere-bvh`` is the port's
flag for what JAX switches with ``SRT_TPU_SPHERE_BVH=on``
(``RenderConfig.sphere_bvh``).

``--engine regen`` (the default) is :func:`render.regen.render_regen`,
``--engine scan`` :func:`render.api.render`; ``--checkpoint`` is
:func:`utils.checkpoint.render_resumable` whatever the engine, as in
JAX. ``--profile DIR`` writes a ``torch.profiler`` trace of the render to
``DIR``. The kernels build into the cache directory
(:mod:`utils.cache`), or, under ``--no-compile-cache``, into a temporary
directory of the process, removed at exit.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
import warnings


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="srt_tpu_torch", description="the path tracer on PyTorch and "
        "CUDA")
    ap.add_argument("--scene", default="cornell_boxes",
                    help="scene name or alias (see --list-scenes)")
    ap.add_argument("--list-scenes", action="store_true")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=0, help="default: square")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=16)
    ap.add_argument("--rr-start", type=int, default=1 << 30,
                    help="bounce index where Russian roulette starts "
                         "(default: off, reference parity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out.png", help=".png or .ppm")
    ap.add_argument("--max-tex", type=int, default=None,
                    help="downsample image textures to <= N px")
    ap.add_argument("--divs", type=int, default=None,
                    help="teapot tessellation override")
    ap.add_argument("--sample-chunk", type=int, default=8)
    ap.add_argument("--metrics", action="store_true",
                    help="print a JSON metrics line to stderr")
    ap.add_argument("--engine", default="regen", choices=["regen", "scan"],
                    help="regen = persistent wavefront with path "
                         "regeneration (fastest); scan = fixed "
                         "scan-over-bounces (differentiable path)")
    ap.add_argument("--checkpoint", default=None, metavar="FILE",
                    help="checkpoint radiance sums to FILE and resume from "
                         "it if present (scan engine)")
    ap.add_argument("--checkpoint-every", type=int, default=64,
                    metavar="SPP", help="spp between checkpoints")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the render to DIR")
    ap.add_argument("--ref-parity", action="store_true",
                    help="reproduce the reference's as-implemented "
                         "estimator (GOLDEN.md) instead of the "
                         "physically-correct one")
    ap.add_argument("--sphere-bvh", action="store_true",
                    help="walk the sphere BVH (scenes of 64 spheres or "
                         "more) where the plain bounce runs, instead of "
                         "sweeping every sphere")
    ap.add_argument("--wavefront", type=int, default=1 << 16,
                    help="regen engine persistent-wavefront lanes")
    ap.add_argument("--pdf-floor", type=float, default=1e-9,
                    help="mixture-pdf cutoff (1e-4 suppresses fireflies)")
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="build the kernels in a temporary directory of "
                         "this process")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the render (default the card)")
    return ap


def _profiler(out_dir: str | None):
    """A ``torch.profiler`` of the CPU and, where present, the card,
    writing a Chrome trace into ``out_dir`` on exit; a null context
    without one."""
    if not out_dir:
        return contextlib.nullcontext()
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(out_dir))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from srt_tpu_torch.scene.library import get_scene, list_scenes
    if args.list_scenes:
        for name in list_scenes():
            print(name)
        return 0

    import numpy as np

    from srt_tpu_torch.io.image import write_png, write_ppm
    from srt_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srt_tpu_torch.render import film
    from srt_tpu_torch.render.api import RenderConfig, render
    from srt_tpu_torch.render.regen import render_regen
    from srt_tpu_torch.utils import cache
    from srt_tpu_torch.utils.checkpoint import render_resumable

    if args.no_compile_cache:
        tmp = tempfile.mkdtemp(prefix="srt_tpu_torch_build_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        cache.enable(tmp)
    else:
        cache.enable()

    height = args.height or args.width
    kw = {}
    if args.max_tex is not None:
        kw["max_tex"] = args.max_tex
    if args.divs is not None:
        kw["divs"] = args.divs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        scene, camera, info = get_scene(args.scene,
                                        aspect=args.width / height,
                                        device=args.device, **kw)
    for w in caught:
        print(f"warning: {w.message}", file=sys.stderr)

    config = RenderConfig(width=args.width, height=height, spp=args.spp,
                          max_depth=args.max_depth, rr_start=args.rr_start,
                          seed=args.seed, sample_chunk=args.sample_chunk,
                          ref_parity=args.ref_parity,
                          sphere_bvh=args.sphere_bvh,
                          wavefront=args.wavefront,
                          pdf_floor=args.pdf_floor)
    reset_launch_counts()
    t0 = time.time()
    with _profiler(args.profile):
        if args.checkpoint:
            out = render_resumable(scene, camera, config, args.checkpoint,
                                   ckpt_every_spp=args.checkpoint_every,
                                   metrics=args.metrics)
        else:
            fn = render_regen if args.engine == "regen" else render
            out = fn(scene, camera, config, metrics=args.metrics)
        img, m = out if args.metrics else (out, None)
        img_np = img.cpu().numpy()        # waits for the card
    wall = time.time() - t0
    tonemapped = film.tonemap(img).cpu().numpy()
    if args.out.lower().endswith(".ppm"):
        write_ppm(args.out, tonemapped)
    else:
        write_png(args.out, tonemapped)

    nan = int(np.isnan(img_np).sum())
    rays = args.width * height * args.spp
    print(f"{args.scene}: {args.width}x{height} spp={args.spp} "
          f"depth<={args.max_depth} in {wall:.1f}s "
          f"({rays / wall:,.0f} primary rays/s) -> {args.out}",
          file=sys.stderr)
    if args.metrics:
        line = {
            "scene": args.scene, "engine": args.engine,
            "wall_s": round(wall, 3),
            "primary_rays_per_sec": round(rays / wall, 1),
            "nan_pixels": nan, "mean": float(img_np.mean()),
            "skipped_assets": info.get("skipped", []),
            "device": str(scene.device),
        }
        line.update(m.to_dict())
        line["launches"] = {k: v for k, v in launch_counts().items() if v}
        print(json.dumps(line), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
