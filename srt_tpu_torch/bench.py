"""Benchmark of the port on one NVIDIA GPU: prints ONE JSON line.

The counterpart of the repository's ``bench.py``, with its flags and its
keys plus ``"backend"`` (``"torch-cuda"`` on the card): primary rays per
second on the reference's default workload, ``ball_scenes`` at 512x512, 16
spp, depth 50, no roulette, through the regeneration engine and its CUDA
kernels; ``--engine scan`` through the scan engine (``render``: chunks of
65,536 pixels × ``--sample-chunk`` samples, 50 lockstep bounces, one B2
launch a bounce); ``--engine both`` times both and reports the faster
under ``engine``, each under ``engines`` and ``warmup_s``. ``--scene``
takes any scene of ``scene.library`` (``cornell_boxes`` the triangle path
with the single-level walk, ``teapot_scene`` the 1,278,400-triangle
teapots through the two-level walk, ``random_scene`` B1's rich
instantiation, ``final``). ``vs_baseline`` divides by the reference C++
renderer's rate recorded in ``BASELINE_MEASURED.json`` (measured on
another machine's CPU).

Beside the main cell, as ``bench.py`` prints them:

* on ``ball_scenes``, ``tri_scene``: :data:`TRI_CELL`, ``cornell_box`` at
  256x256, 8 spp, the run's depth, no roulette, through ``render_regen``,
  one render to warm up and one timed (without its bunny asset the scene
  has no triangles, in both packages: its triangle count goes to stderr);
* with ``--matrix``, every scene of ``list_scenes()`` at
  ``--matrix-width`` squared and ``--matrix-spp`` through ``render_regen``
  with metrics, one render to warm up and one timed (seed 1), with its
  primary rays and path vertices a second; ``--matrix-out FILE`` writes
  the matrix joined against ``BASELINE_CPP.json``'s per-scene C++ rates.

Unlike ``bench.py`` nothing here swallows a failure: a scene that does not
load, an engine, the side cell or a matrix scene that fails raises, and the
process exits non-zero. Every library scene renders on the port.
``--no-cache`` builds the kernels in a temporary directory of the process,
removed at exit (JAX's flag turns off its compile cache). ``--device cpu``
runs the kernels' plain versions on the CPU (the tests do); on the card a
missing GPU raises.

Usage: ``python -m srt_tpu_torch.bench [--scene NAME] [--engine
regen|scan|both] [--width 512] [--spp 16] [--sample-chunk 8] [--matrix]
[--profile DIR]``.
Diagnostics go to stderr; stdout carries exactly one JSON line.
"""
from __future__ import annotations

import argparse
import atexit
import datetime
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from srt_tpu_torch import RenderConfig, get_scene, render, render_regen
from srt_tpu_torch.scene.library import list_scenes
from srt_tpu_torch.utils import cache

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the side cell on ``ball_scenes`` (``bench.py:186-204``)
TRI_CELL = dict(scene="cornell_box", width=256, spp=8)
#: ``BASELINE_CPP.json``'s names that are aliases of the library's
CPP_ALIASES = {"ball_orennayar": "ball_orennayar_scenes"}

ENGINES = {"regen": render_regen, "scan": render}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def baseline_rays_per_sec() -> float:
    with open(os.path.join(_ROOT, "BASELINE_MEASURED.json")) as f:
        return float(json.load(f)["primary_rays_per_sec"])


def profile_one(out_dir: str, fn, scene, camera, config) -> None:
    """One render by ``fn`` under torch.profiler: a chrome trace in
    ``out_dir``, and
    on stderr the device's kernel time by kernel, its sum (device busy)
    and kernel launches per bounce. Only the
    profiler's device rows are summed: a CPU operator's row repeats the
    time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, met = fn(scene, camera, config, metrics=True)
        torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    log(f"[profile] {met.bounces} bounces; device busy {busy_us / 1e6:.4f}s "
        f"in {launches} kernel launches ({launches / met.bounces:.1f} a "
        f"bounce)")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"[profile] {us / 1e3:10.3f} ms {count:6d} calls "
            f"{us / count:9.2f} us/call  {key[:90]}")


def timed(name: str, scene, camera, config, min_seconds: float) -> tuple:
    """Engine ``name`` once to warm up, then renders with seeds 1, 2, ...
    until ``min_seconds`` have passed (at least one, at most 50): ``(reps,
    total seconds, warm-up seconds, the last image)``. Each render is
    read back to the host, which waits for the card."""
    fn = ENGINES[name]
    t0 = time.time()
    img = fn(scene, camera, config).cpu().numpy()
    warmup = round(time.time() - t0, 3)
    log(f"[{name}] warmup (build + first render): {warmup}s")
    reps, total = 0, 0.0
    while (total < min_seconds or reps == 0) and reps < 50:
        cfg = RenderConfig(**{**config.__dict__, "seed": reps + 1})
        t0 = time.time()
        img = fn(scene, camera, cfg).cpu().numpy()
        total += time.time() - t0
        reps += 1
    return reps, total, warmup, img


def tri_cell(max_depth: int, wavefront: int, dev) -> dict:
    """The side cell (:data:`TRI_CELL`): one render to warm up, one timed."""
    c = TRI_CELL
    w = c["width"]
    scene, camera, _ = get_scene(c["scene"], aspect=1.0, device=dev)
    log(f"[tri] {c['scene']}: {scene.n_tris} triangles")
    cfg = RenderConfig(width=w, height=w, spp=c["spp"], max_depth=max_depth,
                       rr_start=1 << 30, wavefront=wavefront)
    render_regen(scene, camera, cfg).cpu()
    t0 = time.time()
    img = render_regen(scene, camera, cfg).cpu().numpy()
    dt = time.time() - t0
    out = {"scene": c["scene"], "width": w, "spp": c["spp"],
           "rays_per_sec": round(w * w * c["spp"] / dt, 1),
           "nan_pixels": int(np.isnan(img).sum())}
    log(f"[tri] {c['scene']}: {out}")
    return out


def scene_matrix(width: int, spp: int, max_depth: int, dev) -> dict:
    """Every library scene through ``render_regen`` at ``width`` squared:
    one render to warm up, one timed (seed 1); per scene ``bench.py``'s
    keys (``bench.py:262-299``): primary rays and path vertices a second
    (the work metric: primary rays hide depth), its triangles, walls, NaN
    pixels and mean, and the assets the library skipped."""
    out = {}
    for name in list_scenes():
        scene, camera, info = get_scene(name, aspect=1.0, device=dev)
        entry = ({"skipped_assets": info["skipped"]} if info.get("skipped")
                 else {})
        cfg = RenderConfig(width=width, height=width, spp=spp,
                           max_depth=max_depth, rr_start=1 << 30)
        t0 = time.time()
        render_regen(scene, camera, cfg, metrics=True)[0].cpu()
        warm = time.time() - t0
        t0 = time.time()
        img, m = render_regen(scene, camera,
                              RenderConfig(**{**cfg.__dict__, "seed": 1}),
                              metrics=True)
        img = img.cpu().numpy()
        dt = time.time() - t0
        entry.update({
            "n_tris": int(scene.n_tris),
            "primary_rays_per_sec": round(width * width * spp / dt, 1),
            "path_vertices_per_sec": round(m.path_vertices / dt, 1),
            "wall_s": round(dt, 2), "warmup_s": round(warm, 1),
            "nan_pixels": int(np.isnan(img).sum()),
            "mean": round(float(img.mean()), 4)})
        out[name] = entry
        log(f"[matrix] {name}: {entry}")
        del scene, camera
    return out


def write_matrix_artifact(path: str, matrix: dict, workload: dict,
                          device: str) -> None:
    """The matrix joined with ``BASELINE_CPP.json`` into one JSON file:
    per scene the port's rays/s, the C++ renderer's and their ratio
    (``bench.py:_write_matrix_artifact``'s keys)."""
    with open(os.path.join(_ROOT, "BASELINE_CPP.json")) as f:
        cpp = {CPP_ALIASES.get(r["scene"], r["scene"]): r
               for r in json.load(f)["scenes"]}
    joined = {}
    for name, entry in matrix.items():
        row = {"srt_tpu_rays_per_sec": entry["primary_rays_per_sec"],
               "path_vertices_per_sec": entry["path_vertices_per_sec"]}
        c = cpp.get(name)
        if c is not None:
            cps = c.get("rays_per_sec") or c.get("rays_per_sec_upper_bound")
            row["cpp_rays_per_sec"] = cps
            row["cpp_note"] = c.get("error")
            if cps and row["srt_tpu_rays_per_sec"]:
                row["vs_cpp"] = round(row["srt_tpu_rays_per_sec"] / cps, 2)
        joined[name] = {k: v for k, v in row.items() if v is not None}
    artifact = {
        "what": f"per-scene srt_tpu_torch ({device}) vs reference C++ "
                "(BASELINE_CPP.json, measured on another machine's CPU), "
                "same workload",
        "workload": workload,
        "date": datetime.date.today().isoformat(),
        "scenes": joined}
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    log(f"[matrix-out] wrote {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="ball_scenes")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=0, help="0 = square")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--min-seconds", type=float, default=3.0)
    ap.add_argument("--sample-chunk", type=int, default=8,
                    help="samples a chunk of the scan engine")
    ap.add_argument("--wavefront", type=int, default=1 << 16)
    ap.add_argument("--engine", default="regen",
                    choices=["regen", "scan", "both"],
                    help="both = time both engines, report the faster")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one render of the "
                         "reported engine to DIR and log device time by "
                         "kernel (on the card)")
    ap.add_argument("--matrix", action="store_true",
                    help="also render every library scene at a smaller size "
                         "and report per-scene rays/s and path-vertices/s")
    ap.add_argument("--matrix-width", type=int, default=256)
    ap.add_argument("--matrix-spp", type=int, default=8)
    ap.add_argument("--matrix-out", default=None, metavar="FILE",
                    help="also write the matrix joined against the "
                         "per-scene C++ baseline (BASELINE_CPP.json)")
    ap.add_argument("--no-cache", action="store_true",
                    help="build the kernels in a temporary directory of "
                         "this process")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card)")
    args = ap.parse_args(argv)
    height = args.height or args.width
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("srt_tpu_torch.bench: no CUDA device")
    if args.profile and not on_card:
        raise SystemExit("srt_tpu_torch.bench: --profile traces the card")
    if args.no_cache:
        tmp = tempfile.mkdtemp(prefix="srt_tpu_torch_build_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        cache.enable(tmp)
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    log(f"device: {dev.type} / {kind}")

    scene, camera, _ = get_scene(args.scene, aspect=args.width / height,
                                 device=dev)
    config = RenderConfig(width=args.width, height=height, spp=args.spp,
                          max_depth=args.max_depth, rr_start=1 << 30,
                          sample_chunk=args.sample_chunk,
                          wavefront=args.wavefront)
    names = list(ENGINES) if args.engine == "both" else [args.engine]
    results = {n: timed(n, scene, camera, config, args.min_seconds)
               for n in names}
    best = min(results, key=lambda n: results[n][1] / results[n][0])
    reps, total, _, img = results[best]
    nan = int(np.isnan(img).sum())
    log(f"[{best}] {reps} rep(s), {total:.3f}s total, mean={img.mean():.4f}, "
        f"nan={nan}")
    if args.profile:
        log(f"[profile] wall per render with the profiler off: "
            f"{total / reps:.4f}s")
        profile_one(args.profile, ENGINES[best], scene, camera, config)

    primary = args.width * height * args.spp
    rays_per_sec = primary * reps / total
    ref = baseline_rays_per_sec()
    result = {
        "metric": "primary_rays_per_sec",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / ref, 3),
        "baseline_rays_per_sec": ref,
        "scene": args.scene,
        "engine": best,
        "engines": {n: {"reps": r[0], "wall_s": round(r[1], 3),
                        "rays_per_sec": round(primary * r[0] / r[1], 1)}
                    for n, r in results.items()},
        "config": {"width": args.width, "height": height, "spp": args.spp,
                   "max_depth": args.max_depth, "reps": reps},
        "device": f"cuda:{kind}" if on_card else "cpu",
        "wall_s": round(total, 3),
        "warmup_s": {n: r[2] for n, r in results.items()},
        "nan_pixels": nan,
        "backend": "torch-cuda" if on_card else "torch-cpu",
    }
    del scene, camera
    if args.scene == "ball_scenes":
        result["tri_scene"] = tri_cell(args.max_depth, args.wavefront, dev)
    if args.matrix:
        result["matrix"] = scene_matrix(args.matrix_width, args.matrix_spp,
                                        args.max_depth, dev)
        if args.matrix_out:
            write_matrix_artifact(
                args.matrix_out, result["matrix"],
                {"width": args.matrix_width, "height": args.matrix_width,
                 "spp": args.matrix_spp, "max_depth": args.max_depth},
                kind)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
