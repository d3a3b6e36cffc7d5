"""Per-phase timing of one bounce on a fixed wavefront (counterpart of
``tools/phases.py``).

Times each piece of the plain bounce on ``--lanes`` camera rays:

  raygen        the camera's rays (``render/camera.py``)
  intersect     :func:`render.intersect.intersect_scene`
  bounce        :func:`render.integrator.bounce_step` (adds media,
                emission, the NEE mixture and shading)

and ``shade_s(est bounce - intersect)``. ``--loop K`` also times the
intersection and the bounce each run K times back to back with one
synchronisation at the end, per run, and the shading pieces alone
(``sample_bsdf``, ``bsdf_pdf``, ``bsdf_weight``, the lights' sample and
pdf, twelve uniforms of the counter RNG), as the JAX tool does inside a
``lax.scan``. The plain pieces are not what a render runs on the card, so
``route`` times the same wavefront through the render's own
:class:`render.route.Route`: its triangle walk alone (``walk_s``, kernel
B3 or B4; absent without triangles) and its whole step (``step_s``: the
walk, then the bounce, kernel B2 where the bounce kernels' gate admits
the scene, else the plain bounce), which ``bounce`` and ``walk`` name.

Each phase runs once to warm up, then ``--reps`` times, timed with CUDA
events on the card and by the wall clock on the CPU.

Usage::

    python -m srt_tpu_torch.phases [--scene ball_scenes] [--lanes 65536]
        [--reps 5] [--loop K] [--device cuda]

Prints one JSON line with the JAX tool's keys (seconds a wavefront, not
rounded) and ``route``.
"""
from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="srt_tpu_torch.phases",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="ball_scenes")
    ap.add_argument("--lanes", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--loop", type=int, default=0, metavar="K",
                    help="also time each phase run K times back to back, "
                         "one synchronisation in all")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card)")
    return ap.parse_args(argv)


def _timer(dev, reps: int):
    """``timeit(fn, *a)``: seconds a call of ``fn`` after one warm-up
    call, over ``reps`` calls; CUDA events on the card, the wall clock on
    the CPU."""
    import torch

    def timeit(fn, *a) -> float:
        with torch.no_grad():
            fn(*a)
            if dev.type != "cuda":
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn(*a)
                return (time.perf_counter() - t0) / reps
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(*a)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps
    return timeit


def run(args: argparse.Namespace) -> dict:
    """Time the phases as the arguments say; returns the JSON record."""
    import torch

    from srt_tpu_torch.core import rng
    from srt_tpu_torch.core.vecmath import to_local
    from srt_tpu_torch.kernels.bounce import StepSpec
    from srt_tpu_torch.materials import materials as mats
    from srt_tpu_torch.render import lights as lg
    from srt_tpu_torch.render.integrator import bounce_step
    from srt_tpu_torch.render.intersect import intersect_scene
    from srt_tpu_torch.render.route import Route
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.scene.library import get_scene

    scene, camera, _ = get_scene(args.scene, aspect=1.0, device=args.device)
    dev = scene.device
    flags = SceneFlags.of(scene)
    n = args.lanes
    pix = torch.arange(n, device=dev) % (512 * 512)
    samp = torch.zeros((n,), dtype=torch.int64, device=dev)
    salt = rng.create_salt(0, pix, samp)
    timeit = _timer(dev, args.reps)

    def raygen(seed):
        s = rng.create_salt(seed, pix, samp)
        u = (pix % 512).to(torch.float32) / 512
        v = (pix // 512).to(torch.float32) / 512
        return camera.rays(u, v, rng.uniform(s, 32), rng.uniform(s, 33),
                           rng.uniform(s, 34))

    o, d, tm = raygen(0)

    def isect(o):
        h = intersect_scene(scene, o, d, 1e-3, None, flags.bvh_leaf, tm)
        return h.t, h.mat

    def state():
        ones = torch.ones((n,), dtype=torch.bool, device=dev)
        return dict(o=o, d=d, time=tm,
                    beta=torch.ones((n, 3), device=dev),
                    radiance=torch.zeros((n, 3), device=dev),
                    alive=ones, salt=salt.to(torch.int32),
                    depth=torch.zeros((n,), dtype=torch.int32, device=dev))

    def bounce():
        out = bounce_step(scene, state(), 50, 1 << 30, flags)
        return out["radiance"], out["beta"], out["d"]

    t_raygen = timeit(raygen, 1)
    t_isect = timeit(isect, o)
    t_bounce = timeit(bounce)
    out = {
        "metric": "phase_seconds_per_wavefront",
        "scene": args.scene, "lanes": n,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "raygen_s": t_raygen,
        "intersect_s": t_isect,
        "bounce_s": t_bounce,
        "shade_s(est bounce - intersect)": t_bounce - t_isect,
        "lanes_per_sec_bounce": n / t_bounce,
    }

    route = Route(scene, flags, StepSpec(max_depth=50, rr_start=1 << 30))
    r = {"bounce": route.bounce, "walk": route.walk,
         "step_s": timeit(lambda: route(state()))}
    if route.walk is not None:
        r["walk_s"] = timeit(route.hits, o, d)
    r["lanes_per_sec_step"] = n / r["step_s"]
    out["route"] = r

    if args.loop:
        k = args.loop

        def isect_loop():
            c = torch.zeros((n,), device=dev)
            for _ in range(k):
                t, _ = isect(o + c[:, None] * 1e-6)
                c = c + t * 0.0 + 1.0
            return c

        def bounce_loop():
            st = state()
            for _ in range(k):
                st = bounce_step(scene, st, 1 << 30, 1 << 30, flags)
                st["alive"] = torch.ones((n,), dtype=torch.bool,
                                         device=dev)   # keep lanes hot
            return st["radiance"]

        t_il = timeit(isect_loop) / k
        t_bl = timeit(bounce_loop) / k
        out["loop_k"] = k
        out["loop_intersect_s"] = t_il
        out["loop_bounce_s"] = t_bl
        out["loop_shade_s"] = t_bl - t_il
        out["loop_lanes_per_sec_bounce"] = n / t_bl

        # the shading pieces alone, each run K times with a dependence
        mat_ids = torch.zeros((n,), dtype=torch.int64, device=dev)
        normal = torch.zeros((n, 3), device=dev)
        normal[:, 2] = 1.0
        uv = torch.zeros((n, 2), device=dev)
        flip = torch.tensor([1.0, 1.0, -1.0], device=dev)

        def sub_loop(fn):
            def run_k():
                c = torch.zeros((n,), device=dev)
                for i in range(k):
                    c = c + fn(rng.hash_combine(salt, i), c) * 1e-12
                return c
            return run_k

        def frame():
            basis = mats.face_basis(normal, d)
            return basis, to_local(basis, -d)

        def f_sample(s, c):
            basis, wo = frame()
            wi = mats.sample_bsdf(scene, mat_ids, basis, wo,
                                  rng.uniform(s, 14) + c * 0,
                                  rng.uniform(s, 15), flags)
            return wi[:, 0]

        def f_pdf(s, c):
            basis, wo = frame()
            return mats.bsdf_pdf(scene, mat_ids, basis, wo,
                                 d * flip + c[:, None] * 1e-12, flags)

        def f_weight(s, c):
            basis, wo = frame()
            w = mats.bsdf_weight(scene, mat_ids, uv, o, basis, wo,
                                 d * flip + c[:, None] * 1e-12, flags)
            return w[:, 0]

        def f_lights(s, c):
            if scene.n_lights == 0:
                return c
            wi = lg.sample_lights(scene, o + c[:, None] * 1e-12,
                                  rng.uniform(s, 13), rng.uniform(s, 14),
                                  rng.uniform(s, 15))
            return lg.lights_pdf(scene, o, wi)

        def f_rng(s, c):
            acc = c
            for dim in range(8, 20):
                acc = acc + rng.uniform(s, dim)
            return acc

        for name, fn in [("sample_bsdf", f_sample), ("bsdf_pdf", f_pdf),
                         ("bsdf_weight", f_weight), ("lights", f_lights),
                         ("rng12", f_rng)]:
            out[f"loop_{name}_s"] = timeit(sub_loop(fn)) / k
    return out


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
