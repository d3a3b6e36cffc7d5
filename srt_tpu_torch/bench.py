"""Benchmark of the port on one NVIDIA GPU: prints ONE JSON line.

The counterpart of the repository's ``bench.py``, with the same keys plus
``"backend": "torch-cuda"``: primary rays per second on the reference's
default workload, ``ball_scenes`` at 512x512, 16 spp, depth 50, no
roulette, through the regeneration engine and its CUDA kernels, or with
``--engine scan`` through the scan engine (``render``: chunks of 65,536
pixels × 8 samples, 50 lockstep bounces, one B2 launch a bounce)
(``--scene cornell_boxes`` takes the triangle path with the single-level
walk, ``--scene teapot_scene`` the 1,278,400-triangle teapots through the
two-level walk; ``--scene`` takes any scene of ``scene.library``, e.g.
``random_scene`` through B1's rich instantiation, or ``final``).
``vs_baseline`` divides by the reference C++ renderer's rate recorded in
``BASELINE_MEASURED.json`` (measured on another machine's CPU).

Usage: ``python -m srt_tpu_torch.bench [--scene NAME] [--engine scan]
[--width 512] [--spp 16] [--profile DIR]``.
Diagnostics go to stderr; stdout carries exactly one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from srt_tpu_torch import RenderConfig, get_scene, render, render_regen

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def baseline_rays_per_sec() -> float:
    with open(os.path.join(_ROOT, "BASELINE_MEASURED.json")) as f:
        return float(json.load(f)["primary_rays_per_sec"])


def profile_one(out_dir: str, fn, scene, camera, config) -> None:
    """One render by ``fn`` under torch.profiler: a chrome trace in
    ``out_dir``, and
    on stderr the device's kernel time by kernel, its sum (device busy),
    kernel launches per bounce, and the busy share of the wall. Only the
    profiler's device rows are summed: a CPU operator's row repeats the
    time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, met = fn(scene, camera, config, metrics=True)
        torch.cuda.synchronize()
    wall = time.time() - t0
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    log(f"[profile] {met.bounces} bounces; device busy {busy_us / 1e6:.4f}s "
        f"in {launches} kernel launches ({launches / met.bounces:.1f} a "
        f"bounce); wall {wall:.4f}s with the profiler on, busy share of it "
        f"{busy_us / 1e6 / wall:.3f}")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"[profile] {us / 1e3:10.3f} ms {count:6d} calls "
            f"{us / count:9.2f} us/call  {key[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="ball_scenes")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=0, help="0 = square")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--min-seconds", type=float, default=3.0)
    ap.add_argument("--wavefront", type=int, default=1 << 16)
    ap.add_argument("--engine", default="regen", choices=["regen", "scan"])
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one rep to DIR "
                         "and log device time by kernel")
    args = ap.parse_args()
    height = args.height or args.width
    if not torch.cuda.is_available():
        raise SystemExit("srt_tpu_torch.bench: no CUDA device")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"device: cuda / {kind}")

    scene, camera, _ = get_scene(args.scene, aspect=args.width / height,
                                 device=dev)
    config = RenderConfig(width=args.width, height=height, spp=args.spp,
                          max_depth=args.max_depth, rr_start=1 << 30,
                          wavefront=args.wavefront)
    fn = render_regen if args.engine == "regen" else render
    t0 = time.time()
    img = fn(scene, camera, config).cpu().numpy()
    warmup = round(time.time() - t0, 3)
    log(f"[{args.engine}] warmup (build + first render): {warmup}s")
    reps, total = 0, 0.0
    while total < args.min_seconds and reps < 50:
        cfg = RenderConfig(**{**config.__dict__, "seed": reps + 1})
        t0 = time.time()
        img = fn(scene, camera, cfg).cpu().numpy()
        total += time.time() - t0
        reps += 1
    nan = int(np.isnan(img).sum())
    log(f"{reps} rep(s), {total:.3f}s total, mean={img.mean():.4f}, "
        f"nan={nan}")

    rays_per_sec = args.width * height * args.spp * reps / total
    if args.profile:
        log(f"[profile] wall per render with the profiler off: "
            f"{total / reps:.4f}s")
        profile_one(args.profile, fn, scene, camera, config)

    ref = baseline_rays_per_sec()
    print(json.dumps({
        "metric": "primary_rays_per_sec",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / ref, 3),
        "baseline_rays_per_sec": ref,
        "scene": args.scene,
        "engine": args.engine,
        "engines": {args.engine: {"reps": reps, "wall_s": round(total, 3),
                                  "rays_per_sec": round(rays_per_sec, 1)}},
        "config": {"width": args.width, "height": height, "spp": args.spp,
                   "max_depth": args.max_depth, "reps": reps},
        "device": f"cuda:{kind}",
        "wall_s": round(total, 3),
        "warmup_s": {args.engine: warmup},
        "nan_pixels": nan,
        "backend": "torch-cuda",
    }), flush=True)


if __name__ == "__main__":
    main()
