"""Golden-image PSNR of a render (counterpart of ``tools/golden.py``).

Renders a library scene with the regeneration engine, or with the scan
engine under ``--engine scan`` or ``--seq-stale`` (the JAX tool's choice,
``tools/golden.py:80``), writes its tonemapped image as an ASCII PPM, and
compares it with a golden: an ASCII
PPM or an 8-bit RGB PNG such as the asset-free ``goldens/cornell_boxes_512
.png`` (read with numpy and ``zlib``, no Pillow). ``--ref-parity`` renders
the reference's as-implemented estimator, the one its own goldens bake in
(``GOLDEN.md``), and asks the scene for first-mesh-only loading, as the
JAX tool does (no scene of the port loads a mesh file yet: one that would
raises, ROADMAP A8). ``--seq-stale`` with ``--ref-parity`` renders each
pixel's samples one after another, carrying the heap-slot plane.

Usage::

    python -m srt_tpu_torch.golden --scene cornell_boxes --size 512 \\
        --spp 64 --golden goldens/cornell_boxes_512.png [--ref-parity]
        [--device cpu]

Prints one JSON line with ``tools/golden.py``'s keys: the settings, the
render's ``wall_s`` and file (``ours``), and with a golden ``golden``,
``psnr_db``, ``mean_ours``, ``mean_golden`` (8-bit scale) and, with
``--downsample`` above 1, ``psnr_ds_db`` of the box-filtered images.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="cornell_boxes")
    ap.add_argument("--spp", type=int, default=128)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--golden", default="",
                    help="golden image (.ppm or .png); none: render only")
    ap.add_argument("--out-dir", default="goldens")
    ap.add_argument("--engine", default="regen", choices=["regen", "scan"])
    ap.add_argument("--downsample", type=int, default=4)
    ap.add_argument("--ref-parity", action="store_true",
                    help="the reference's as-implemented estimator and "
                         "first-mesh-only loading")
    ap.add_argument("--pdf-floor", type=float, default=1e-9,
                    help="mixture-pdf cutoff; 1e-4 suppresses fireflies")
    ap.add_argument("--seq-stale", action="store_true",
                    help="carry the heap slot across a pixel's samples "
                         "(scan engine)")
    ap.add_argument("--parity-no-stale", action="store_true",
                    help="diagnostic: the heap slot reads 0")
    ap.add_argument("--save-linear", action="store_true",
                    help="also save the pre-tonemap linear radiance .npy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-name", default=None,
                    help="override the output ppm filename")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the render (default the card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Render and compare as the arguments say; returns the JSON record."""
    import numpy as np

    from srt_tpu_torch import RenderConfig, get_scene, render, render_regen
    from srt_tpu_torch.io.image import read_image, write_ppm
    from srt_tpu_torch.render import film
    from srt_tpu_torch.utils.compare import golden_psnr

    kw = {"first_mesh_only": True} if args.ref_parity else {}
    scene, camera, info = get_scene(args.scene, aspect=1.0,
                                    device=args.device, **kw)
    if info.get("skipped"):
        print(f"WARNING: assets skipped: {info['skipped']}", file=sys.stderr)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       max_depth=args.max_depth, rr_start=1 << 30,
                       pdf_floor=args.pdf_floor, ref_parity=args.ref_parity,
                       seed=args.seed, seq_stale=args.seq_stale,
                       parity_no_stale=args.parity_no_stale)
    fn = (render_regen if args.engine == "regen" and not args.seq_stale
          else render)
    t0 = time.time()
    img = fn(scene, camera, cfg)
    tm = film.tonemap(img).cpu().numpy()
    wall = time.time() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    name = args.out_name or f"{args.scene}_{args.size}.ppm"
    ours_path = os.path.join(args.out_dir, name)
    write_ppm(ours_path, tm)
    if args.save_linear:
        np.save(ours_path.replace(".ppm", "_lin.npy"),
                img.cpu().numpy())
    result = {"scene": args.scene, "spp": args.spp, "size": args.size,
              "pdf_floor": args.pdf_floor, "max_depth": args.max_depth,
              "wall_s": round(wall, 1), "ours": ours_path}
    if args.golden and os.path.exists(args.golden):
        result["golden"] = args.golden
        result.update(golden_psnr(tm, read_image(args.golden),
                                  downsample=args.downsample))
    else:
        print(f"golden {args.golden!r} not found; render-only run",
              file=sys.stderr)
    return result


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))))


if __name__ == "__main__":
    main()
