"""Train-step throughput of the port on one NVIDIA GPU: prints ONE JSON
line (counterpart of ``tools/trainbench.py``, same keys plus
``"backend": "torch-cuda"``).

Times one inverse-rendering train step -- forward, backward, Adam -- of
``ball_scenes`` through the regeneration engine, whose bounce is kernel B2
forward and kernel B5 backward. Defaults are the JAX package's r5 train
configuration at 256x256: 4 spp, depth 50, a 16,384-lane wavefront, depth
budget 4.0, drain 12 (76 bounces a step), parameters ``{"tex_color"}``,
Adam at 1e-2 towards a constant 0.3 image. On a scene with the rich
families (``--scene two_spheres``, ``two_perlin_spheres``,
``earth_sphere``: checker and noise textures, image emission, sphere
lights) the bounce is B2's and B5's rich instantiations. With ``--scene
cornell_boxes`` (triangles) or ``random_scene`` (moving spheres) the
bounce is kernel B3 then B2 forward, or B2 alone, and the hybrid backward
(the plain bounce replayed under autograd with B6's sphere winner,
``kernels/bounce_vjp.py``). Geometric parameters are timed by
``chip_smoke.py`` phase 15. ``--engines regen scan`` also times the
lockstep scan engine's step (``make_train_step(engine="scan")``, every
bounce of every ray kept for the backward), as ``tools/trainbench.py``
times both, and with both the line carries ``speedup_regen_vs_scan``.
``tools/trainbench.py``'s ``--unroll`` is ``lax.scan``'s unroll; the
port's train loop is a Python loop of eager launches, not a compiled
scan, so it has no counterpart.

Usage: ``python -m srt_tpu_torch.trainbench [--width 256] [--engines regen
scan] [--profile DIR]``.
``--profile`` adds one step timed phase by phase (forward, backward, Adam)
and one step under ``torch.profiler``. Diagnostics go to stderr; stdout
carries exactly one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from srt_tpu_torch import get_scene, make_train_step


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def profile_step(out_dir: str, step, target, seed: int) -> dict:
    """One train step under torch.profiler: a chrome trace in ``out_dir``,
    device time by kernel on stderr; returns the device's busy time and
    the busy time of each bounce kernel. Only the profiler's device rows
    are summed: a CPU operator's row repeats the time of the kernels it
    launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(target, seed)
        torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "train_trace.json"))
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    log(f"[profile] device busy {busy_us / 1e6:.4f}s")
    kernels = {}
    for rank, (us, count, key) in enumerate(sorted(rows, reverse=True)):
        if us and rank < 15:
            log(f"[profile] {us / 1e3:10.3f} ms {count:6d} calls "
                f"{us / count:9.2f} us/call  {key[:90]}")
        if any(k in key for k in ("::bounce_kernel<", "::bounce_bwd_kernel<",
                                  "::sphere_winner_kernel<",
                                  "::intersect_tris_kernel(",
                                  "::intersect_big_kernel(")):
            kernels[key] = {"us_per_launch": us / max(count, 1),
                            "launches": count}
    return {"device_busy_s": busy_us / 1e6, "kernels": kernels}


def phase_walls(step, target, seed: int) -> dict:
    """One train step with the card synchronised between its phases: the
    host-clock seconds of the forward (the loss, 76 B2 launches at the
    default configuration), the backward (76 B5 launches) and Adam, and
    the device memory peak of the step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step.optimizer.zero_grad(set_to_none=True)
    t0 = time.time()
    loss = step.loss_fn(step.params, step.target(target), seed)
    torch.cuda.synchronize()
    t1 = time.time()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.time()
    step.optimizer.step()
    torch.cuda.synchronize()
    t3 = time.time()
    return {"forward_s": t1 - t0, "backward_s": t2 - t1, "adam_s": t3 - t2,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="ball_scenes")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--wavefront", type=int, default=1 << 14)
    ap.add_argument("--depth-budget", type=float, default=4.0)
    ap.add_argument("--drain", type=int, default=12)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--engines", nargs="+", default=["regen"],
                    choices=["regen", "scan"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one step to DIR "
                         "and log device time by kernel")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("srt_tpu_torch.trainbench: no CUDA device")
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    scene, camera, _ = get_scene(args.scene, aspect=1.0, device=dev)
    w = args.width
    rays = w * w * args.spp
    target = torch.full((w, w, 3), 0.3, device=dev)
    engines = {}
    for engine in args.engines:
        step = make_train_step(
            scene, camera, {"tex_color": scene.tex_color}, width=w,
            height=w, spp=args.spp, max_depth=args.max_depth, lr=args.lr,
            engine=engine,
            engine_kw=(dict(wavefront=args.wavefront,
                            depth_budget=args.depth_budget, drain=args.drain)
                       if engine == "regen" else None),
            device=dev)
        t0 = time.time()
        loss = float(step(target, 0))
        sync()
        warm = time.time() - t0
        walls = []
        for r in range(args.reps):
            t0 = time.time()
            loss = float(step(target, r + 1))
            sync()
            walls.append(time.time() - t0)
        dt = sorted(walls)[len(walls) // 2]
        rec = {"rays_per_sec": round(rays / dt, 1),
               "step_wall_s": round(dt, 4),
               "step_walls_s": [round(x, 4) for x in walls],
               "warmup_s": round(warm, 3), "loss": round(loss, 5)}
        log(f"[trainbench] {engine}: {rec}")
        if args.profile and on_card:
            rec["phases"] = phase_walls(step, target, args.reps + 1)
            log(f"[trainbench] phases: {rec['phases']}")
            rec["profile"] = profile_step(
                os.path.join(args.profile, engine), step, target,
                args.reps + 2)
        engines[engine] = rec
        del step
    out = {"metric": "train_step_rays_per_sec", "scene": args.scene,
           "width": w, "spp": args.spp, "max_depth": args.max_depth,
           "device": kind, "engines": engines,
           "backend": "torch-cuda" if on_card else "torch-cpu"}
    if "regen" in engines and "scan" in engines:
        out["speedup_regen_vs_scan"] = round(
            engines["regen"]["rays_per_sec"] / engines["scan"]["rays_per_sec"],
            2)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
