"""Average render chunks in linear radiance and PSNR them against a golden
(counterpart of ``tools/golden_avg.py``).

A long render can be made as several seed chunks (``python -m
srt_tpu_torch.golden --spp S --seed k --out-name ...``), each written as a
tonemapped 8-bit image. This tool decodes each chunk's sqrt gamma back to
linear radiance (``u8 / 255`` squared: averaging the gamma values would
bias the mean), averages the chunks, re-applies the gamma and reports the
PSNR against the golden (:func:`utils.compare.golden_psnr`). Chunks and
golden are ASCII PPMs or 8-bit RGB PNGs (:func:`io.image.read_image`).

Usage::

    python -m srt_tpu_torch.golden_avg --chunks 'goldens/ball_s*.ppm' \\
        --golden goldens/ball_parity_4096avg.png [--out avg.ppm]
        [--downsample 4]

Prints one JSON line with the JAX tool's keys: ``n_chunks``, ``golden``,
``chunks`` and those of ``golden_psnr``.
"""
from __future__ import annotations

import argparse
import glob
import json


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="srt_tpu_torch.golden_avg",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", required=True,
                    help="glob of tonemapped chunk images (.ppm or .png)")
    ap.add_argument("--golden", required=True)
    ap.add_argument("--out", default=None,
                    help="write the averaged tonemapped PPM here")
    ap.add_argument("--downsample", type=int, default=4)
    return ap.parse_args(argv)


def average(paths: list[str]):
    """The chunks' mean in linear radiance, tonemapped back: (h, w, 3)
    float64 in [0, 1]."""
    import numpy as np

    from srt_tpu_torch.io.image import read_image
    acc = None
    for p in paths:
        u8 = read_image(p).astype(np.float64) / 255.0
        lin = u8 * u8            # invert the sqrt gamma -> linear radiance
        acc = lin if acc is None else acc + lin
    return np.sqrt(np.clip(acc / len(paths), 0.0, 1.0))


def run(args: argparse.Namespace) -> dict:
    """Average and compare as the arguments say; returns the JSON
    record."""
    import numpy as np

    from srt_tpu_torch.io.image import read_image, write_ppm
    from srt_tpu_torch.utils.compare import golden_psnr

    paths = sorted(glob.glob(args.chunks))
    if not paths:
        raise SystemExit(f"no chunks match {args.chunks}")
    tm = average(paths)
    if args.out:
        write_ppm(args.out, tm.astype(np.float32))
    result = {"n_chunks": len(paths), "golden": args.golden,
              "chunks": args.chunks}
    result.update(golden_psnr(tm, read_image(args.golden),
                              downsample=args.downsample))
    return result


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
