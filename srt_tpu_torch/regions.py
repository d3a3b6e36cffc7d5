"""Region-isolated golden A/B of the soldier scene (counterpart of
``tools/regions.py``).

Segments the square frame by the scene's camera geometry (a pinhole
projection of the floor plane and of the soldier's bounds, :func:`masks`)
and reports the mean 8-bit RGB of each region -- floor, sky, soldier --
of the golden and of a render for each floor variant
(``soldier_scene``'s ``floor_variant``: ``ref``, ``nocoat``, ``lambert``,
``rect``), each variant isolating one hypothesis for the floor's
brightness. The render is :func:`render.regen.render_regen`; the soldier
mesh renders as what the scene loads (nothing where the asset is absent),
as every asset scene does. The golden is
``goldens/soldier_scene_500.png`` unless ``--golden`` names another, read
as a PPM or a PNG; it is compared only at its own size.

Usage::

    python -m srt_tpu_torch.regions [--spp 64] [--size 500]
        [--variants ref nocoat lambert] [--no-soldier] [--ref-parity]
        [--golden PATH] [--out-dir goldens] [--device cuda]

Prints one JSON line with the JAX tool's keys (``spp``, ``size``,
``regions``, ``golden`` and one entry a variant with its region means and
its tonemapped ``ppm``).
"""
from __future__ import annotations

import argparse
import json
import os

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "soldier_scene_500.png")


def masks(size: int):
    """(floor, sky, soldier) boolean masks (size, size) from the scene's
    camera geometry, as ``tools/regions.py:masks`` draws them. Pinhole
    rays (the aperture ignored: bokeh only blurs region edges, which are
    eroded away): camera at (300, 500, -800) looking at (300, 278, 200),
    vfov 40, square aspect (``Raytracing_n.cpp:587-592``)."""
    import numpy as np

    lookfrom = np.array([300.0, 500.0, -800.0])
    lookat = np.array([300.0, 278.0, 200.0])
    vup = np.array([0.0, 1.0, 0.0])
    half_h = np.tan(np.radians(40.0) / 2)
    w = lookfrom - lookat
    w /= np.linalg.norm(w)
    u = np.cross(vup, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)

    js, is_ = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    # row j of the image is t = (size-1-j)/size of the film plane
    s = (is_ + 0.5) / size
    t = ((size - 1 - js) + 0.5) / size
    d = ((2 * s - 1)[..., None] * half_h * u
         + (2 * t - 1)[..., None] * half_h * v - w)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    # the floor plane y = 0.1, bounded to the boxes' [0, 600]^2 footprint
    dy = d[..., 1]
    tt = (0.1 - lookfrom[1]) / np.where(np.abs(dy) < 1e-9, 1e-9, dy)
    p = lookfrom + tt[..., None] * d
    floor = ((dy < 0) & (p[..., 0] >= 0) & (p[..., 0] <= 600)
             & (p[..., 2] >= 0) & (p[..., 2] <= 600))
    sky = ~floor

    # the soldier's bounds (the mesh scaled x8, turned 180 degrees, at
    # (250, 0, 300)): a pixel is the soldier's if its ray crosses the box
    lo = np.array([140.0, -10.0, 220.0])
    hi = np.array([410.0, 430.0, 390.0])
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    t0 = (lo - lookfrom) * inv
    t1 = (hi - lookfrom) * inv
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    soldier = tf > np.maximum(tn, 0)

    def erode(m, it=3):
        """Drop pixels within ``it`` px of a mask edge (bokeh mixes
        them)."""
        for _ in range(it):
            m = (m & np.roll(m, 1, 0) & np.roll(m, -1, 0)
                 & np.roll(m, 1, 1) & np.roll(m, -1, 1))
        return m

    return erode(floor & ~soldier), erode(sky & ~soldier), soldier


def region_stats(img_u8, floor, sky, soldier) -> dict:
    """Each region's mean RGB on the 8-bit scale, to two decimals."""
    import numpy as np
    a = np.asarray(img_u8, np.float64)
    return {f"{name}_rgb": [round(x, 2) for x in a[m].mean(0)]
            for name, m in (("floor", floor), ("sky", sky),
                            ("soldier", soldier))}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="srt_tpu_torch.regions",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--variants", nargs="+", default=["ref"],
                    choices=["ref", "nocoat", "lambert", "rect"])
    ap.add_argument("--no-soldier", action="store_true")
    ap.add_argument("--ref-parity", action="store_true")
    ap.add_argument("--golden", default=GOLDEN)
    ap.add_argument("--out-dir", default="goldens",
                    help="where each variant's tonemapped PPM goes")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renders (default the card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Render and compare as the arguments say; returns the JSON record."""
    import numpy as np

    from srt_tpu_torch.io.image import read_image, write_ppm
    from srt_tpu_torch.render import film
    from srt_tpu_torch.render.api import RenderConfig
    from srt_tpu_torch.render.regen import render_regen
    from srt_tpu_torch.scene.library import get_scene

    floor, sky, soldier = masks(args.size)
    out = {"spp": args.spp, "size": args.size,
           "regions": {"floor_px": int(floor.sum()),
                       "sky_px": int(sky.sum()),
                       "soldier_px": int(soldier.sum())}}
    if os.path.exists(args.golden):
        gold = read_image(args.golden)
        if gold.shape[:2] == (args.size, args.size):
            out["golden"] = region_stats(gold, floor, sky, soldier)

    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       max_depth=args.max_depth, rr_start=1 << 30,
                       ref_parity=args.ref_parity)
    os.makedirs(args.out_dir, exist_ok=True)
    for variant in args.variants:
        scene, camera, _ = get_scene(
            "soldier_scene", aspect=1.0, device=args.device,
            floor_variant=variant, no_soldier=args.no_soldier,
            first_mesh_only=args.ref_parity)
        img = render_regen(scene, camera, cfg)
        tm = np.clip(film.tonemap(img).cpu().numpy() * 255.99, 0, 255)
        out[variant] = region_stats(tm, floor, sky, soldier)
        path = os.path.join(args.out_dir, f"regions_{variant}"
                            f"{'_ns' if args.no_soldier else ''}.ppm")
        write_ppm(path, tm / 255.0)
        out[variant]["ppm"] = path
    return out


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
