"""Smoke run of the PyTorch/CUDA port (``srt_tpu_torch``) on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py [--ppm OUT.ppm]`` from the repository root.
Needs one CUDA device; imports neither JAX nor ``srt_tpu``. Phases, each
of which raises on failure:

1. the device: its name and power limit from ``nvidia-smi``;
2. build: ``nvcc`` compiles each ``srt_tpu_torch/csrc/*.cu`` for
   ``sm_90a``, all at once, and links one library;
3. the regeneration kernel (B1) against its plain PyTorch version on the
   card: one step of a mid-flight 65,536-lane ball_scenes wavefront lane
   by lane, a 64x64, 4 spp, depth 8 image, and the time per bounce of each
   (the kernel's as bare launches on fixed arguments, and through its
   wrapper); ``ptxas``' registers of B1's four instantiations, lean and
   rich, static and moving, and of B2's eight (with and without the
   external hit);
4. the render path: ``render_regen`` on ball_scenes at 512x512, 16 spp,
   depth 50, a 65,536-lane wavefront and seed 0, through B1, once to warm
   up and five times timed;
5. the train kernels against their plain versions on the card, on a
   16,384-lane ball_scenes state (``render_pixels``' camera rays, three
   plain bounces, a seeded half of the lanes dead): one launch of the
   forward kernel (B2) against the plain step, one launch of the backward
   kernel (B5) against ``torch.autograd`` of the plain step, and the time
   per bounce of each;
6. the train path: ``make_train_step`` on ball_scenes at 256x256, 4 spp,
   depth 50, a 16,384-lane wavefront, depth budget 4.0, drain 12,
   parameters ``{"tex_color"}``, Adam at 1e-2, a constant 0.3 target: one
   step to warm up, then three timed steps with seeds 1-3, 76 bounces
   each, every bounce one B2 and one B5 launch;
7. the triangle BVH kernel (B3) against its plain version on two inputs:
   a mid-flight 65,536-lane cornell_boxes wavefront, and the 4,800
   triangles of ``final``'s ground field (its 400 boxes and their seeded
   heights) under ``final``'s camera rays: hit and index equality, |dt|
   within 2e-5 and |du|, |dv| within 1e-4 on the hits, the time per
   launch and the bound;
8. B2's external-hit mode against its plain version on input (a);
9. the triangle render path: ``render_regen`` on cornell_boxes at 512x512,
   16 spp, depth 50, a 65,536-lane wavefront and seed 0, first kernels
   against plain versions on a 64x64, 4 spp, depth 8 image, then once to
   warm up and three times timed, every bounce one B3 and one B2 launch;
10. the two-level BVH kernel (B4) against its plain version on
   ``teapot_scene`` at divs=100 (1,278,400 triangles; the seconds of the
   host build's tessellation, BVH, clusters and upload as the builder
   records them), on two inputs: the camera rays of a 65,536-lane
   wavefront at rows 448-455 (the teapots and the glass sphere) and the
   same wavefront after three plain bounces: hit and index equality, |dt|
   within 2e-5 and |du|, |dv| within 1e-4 on the hits, B4 against B3 on
   the same rays, the time per launch of B4, B3 and the plain walk, and
   the bound from the records the plain walk read; the kernels line takes
   B4's numbers from the bounced input;
11. B2's external-hit mode with the specular branch and the media sweep
   against its plain version on the post-bounce teapot wavefront;
12. the teapot render path: ``render_regen`` on teapot_scene at 512x512,
   16 spp, depth 50, a 65,536-lane wavefront and seed 0, first kernels
   against plain versions on a 32x32, 4 spp, depth 8 image, then once to
   warm up and three times timed, every bounce one B4 and one B2 launch
   and no B3 or B1;
13. the sphere-winner kernel (B6) against its plain version on three
   inputs: the 16,384-lane ball_scenes train wavefront after two bounces,
   65,536 ball_scenes camera rays, and a 20-sphere scene of moving,
   flipped and plain spheres in an env dome under 65,536 random rays:
   index equal and ``t`` equal to the bit; the time per launch and the
   bound;
14. B1 and B2 with moving spheres (``kMoving``) against their plain
   versions under the per-bounce contract: ball_scenes with every ball's
   ``center1 = center0 + (0, 10, 0)``, one step of a mid-flight
   65,536-lane B1 wavefront and one B2 launch on a 16,384-lane train
   state;
15. the geometry train step: the hybrid backward's per-bounce cotangents
   (the rows, the material table, ``sph_center0``, ``sph_radius``,
   ``rect_k``) against ``torch.autograd`` of the plain step with its own
   sphere sweep on a 16,384-lane state; then ``make_train_step`` on
   ball_scenes with ``{"sph_center0", "sph_radius", "rect_k"}`` at phase
   6's width and engine, one step to warm up and three timed, every
   bounce one B2 and one B6 launch and no B5; the losses and the three
   gradients finite, the gradients nonzero;
16. the cornell_boxes train step with ``{"tex_color"}`` at 128x128, 4 spp,
   depth 50 on phase 6's engine: first B3 against its plain walk (as in
   phase 7) and B2's external-hit mode against its plain version (as in
   phase 8) on a 16,384-lane cornell_boxes train state, with their times
   at that shape; then one step to warm up and one counted, every bounce
   one B3 and one B2 launch and no B6 or B5; the loss and the gradient
   finite;
17. B1's rich instantiation against its plain version on one mid-flight
   65,536-lane step of ``random_scene``, ``two_perlin_spheres``,
   ``earth_sphere`` and a room with a sphere and a box medium
   (``tests/_torch_scenes.py:lit_room_media``), and its lean one on
   ``final1``'s 1,000 spheres (48 KB of shared memory), under the
   per-bounce contract, with the families each step shaded, the time per
   launch and the bound;
18. B2's external-hit mode with marble and image albedo against its plain
   version on a mid-flight 65,536-lane ``final`` wavefront (its 4,800
   triangles walked by B3); then the new path: ``render_regen`` on
   ``random_scene`` at 512x512, 16 spp, depth 50, a 65,536-lane wavefront
   and seed 0 through B1's rich instantiation, once to warm up and three
   times timed, every bounce one B1 launch, the mean and the NaN pixels;
19. the rich train kernels against their plain versions on a mid-flight
   16,384-lane train state (phase 5's) of each of ``two_spheres``,
   ``two_perlin_spheres``, ``earth_sphere`` and the media room: one launch
   of B2's rich instantiation against the plain step under the per-bounce
   contract, and one of B5's (``csrc/bounce_bwd.cu``, ``kRich``) against
   ``torch.autograd`` of it, the state cotangents under ``check_grads``
   and the (M, 14) material sums within ``GRAD_RTOL``; the lanes of each
   family, each kernel's time per bare launch and its bound; ``ptxas``'
   registers of both B5 instantiations;
20. the train step on the rich families at phase 6's settings: each of
   those four scenes through ``make_train_step`` (``{"tex_color"}``, the
   media room ``{"mat_params", "tex_color"}``), one step to warm up, three
   timed and one split into forward, backward and Adam, every bounce one
   B2 and one rich B5 launch and no B6; then, on a 16,384-lane
   ``random_scene`` train state, B2's rich ``kMoving`` instantiation
   against the plain step and B6 against its plain version on its 484
   moving spheres (as in phase 13), and the hybrid on
   ``random_scene`` (moving spheres) with ``{"tex_color"}`` at 64x64, 4
   spp, depth 50, one step (the width cut because the hybrid's torch
   replay takes about 0.1 s a bounce), every bounce one B2 and one B6
   launch and no B5; the losses and gradients finite, no NaN.

Prints one JSON line about the kernels, then the ``nvidia-smi`` line, then
``{"ok": true, "device": {...}}`` as the last line.

``python3 chip_smoke.py --compare TREE [TREE ...]`` instead
times B1, B3, B2's external hit, the ball_scenes render and three train
steps from each checkout TREE in turns (see ``compare``), for example the
parent commit unpacked with ``git archive`` under ``build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

LANES = 1 << 16
MAIN = dict(width=512, height=512, spp=16, max_depth=50, seed=0,
            rr_start=1 << 30, wavefront=LANES)
MAIN_REPS = 5       # one render takes tens of ms; its rate varies by run
TRAIN = dict(width=256, height=256, spp=4, max_depth=50)
TRAIN_ENGINE = dict(wavefront=1 << 14, depth_budget=4.0, drain=12)
TRAIN_LANES = 1 << 14
TRAIN_STEPS = 3
TRAIN_TARGET = 0.3
TRAIN_LR = 1e-2

# H100 SXM peaks at 700 W (NVIDIA's data sheet): float32 outside the
# tensor cores, and HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# Operations per lane, counted from srt_tpu_torch/csrc/bounce_core.cuh
# (arithmetic and transcendental operations alike count one): one sphere
# test of closest_hit, one rect test, and shade<float> on a lane
# (Beckmann VNDF with about four Newton rounds, light sample, pdfs)
OPS_SPHERE = 21
OPS_RECT = 10
OPS_SHADE = 600
# The triangle walk (csrc/tri_bvh.cuh), counted the same way: the three
# guarded reciprocals of a ray, one node's slab test, one Möller–Trumbore
# test, and B2's assembly of a triangle hit (interpolation, normalise)
OPS_RAY = 12
OPS_SLAB = 25
OPS_TRI = 61
OPS_TRI_HIT = 40
TRI_MAIN_REPS = 3
# B2's media sweep, per medium a lane (take_media: the sphere and slab
# crossings, the free-flight draw and log), and its specular branch on a
# specular lane (scatter_specular: reflection, the fuzz ball or Schlick's
# choice, normalisation, two to four uniforms)
OPS_MEDIUM = 90
OPS_SPECULAR = 120
TEAPOT_DIVS = 100
TEAPOT_ROW = 448
# the teapot image's mean at 512x512, 16 spp, depth 50: the plain version
# on the CPU at 64x64, 4 spp, depth 50 (divs=6) gave 0.584
TEAPOT_MEAN = (0.45, 0.75)
# B3 against the plain walk on the rays both call a hit: JAX's own bounds
# between its XLA walk and its Pallas kernel (tests/test_pallas.py)
TRI_T_ATOL = 2e-5
TRI_UV_ATOL = 1e-4
# B5's bound counts what the bounce's VJP needs, not what the kernel's
# forward-mode passes do: the sweeps once in float, and the shading
# VJP_SHADE times the forward's operations -- the forward replayed once,
# then its reverse sweep at about twice the forward (the adjoint of a
# product is two products and two sums), as a reverse-mode VJP such as
# the JAX kernel's jax.vjp costs
VJP_SHADE = 3
# phase 19's scenes and the families each state must hold
RICH_BWD_EXPECT = {"two_spheres": ("checker", "sphere_light_sample"),
                   "two_perlin_spheres": ("marble", "sphere_light_sample"),
                   "earth_sphere": ("image", "sphere_light_sample"),
                   "lit_room_media": ("medium", "specular", "image")}
# phase 20's hybrid step on random_scene (moving spheres): the width cut
# from the train cell's 256 to keep the torch replay's ~0.1 s a bounce
# inside the time limit
HYBRID_RICH = dict(width=64, height=64, spp=4, max_depth=50)
# B6: one sphere test of sphere_t with the motion lerp (a lerp of the
# centre, the quadratic, the root choice), counted the same way
OPS_SPHERE_MOVING = 28
GEOM_PARAMS = ("sph_center0", "sph_radius", "rect_k")
CORNELL_TRAIN = dict(width=128, height=128, spp=4, max_depth=50)
MOVE_Y = 10.0           # phase 14: each ball's centre1 - centre0 in y
# The rich instantiation, counted the same way from bounce_core.cuh: the
# checker (three scaled sines and their product, texture_at), one Perlin
# octave's setup (floors, fractions, hermite weights, six permutation
# reads, the octave's weight and the doubled point) and one of its eight
# corners (a gradient read by xor, the dot, the trilinear weight), marble's
# closing sine; an image lookup (sphere uv, texel, unpack); a sphere
# light's cone sample (sphere_light_dir) and its pdf (sphere_light_pdf)
OPS_CHECKER = 9
OPS_OCTAVE = 36
OPS_CORNER = 16
OPS_MARBLE = 7 * (OPS_OCTAVE + 8 * OPS_CORNER) + 8
OPS_IMAGE = 20
OPS_SPHERE_SAMPLE = 75
OPS_SPHERE_PDF = 35
# phase 17's scenes and the image row the work cursor starts at (rows
# their objects fill)
RICH_CASES = (("random_scene", 216), ("final1", 220),
              ("two_perlin_spheres", 240), ("earth_sphere", 200),
              ("lit_room_media", 296))
FINAL_ROW = 280         # phase 18: final's marble and earth spheres
# random_scene's mean at 512x512x16x50: the plain version on the CPU at
# 64x64, 4 spp, depth 50 gave 0.409
RICH_MEAN = (0.3, 0.55)
# --compare: kernel timing rounds a run, 50 (B1) or 200 launches each
COMPARE_ROUNDS = 5


def log(*a):
    print(*a, flush=True)


def clone(st: dict) -> dict:
    return {k: v.clone() for k, v in st.items()}


def bound(n_bytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory
    rate or operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_bounces(step, inp, st0, spec, reps: int) -> float:
    """Milliseconds per bounce over ``reps`` steps from a copy of ``st0``."""
    st = clone(st0)
    return time_ms(lambda: step(inp, st, spec), reps)


def bare_launch_ms(entry: str, size: int, call, reps: int) -> float:
    """Milliseconds per launch of the library's ``entry`` over ``reps``
    bare launches: the ``size``-byte arguments of two calls of its
    wrapper ``call`` are captured and replayed in turn (B1's work-queue
    buffers alternate as its wrapper swaps them), so the wrapper's host
    work stays out of the timed loop. What ``call`` returns is held, so
    its outputs outlive the capture. Any version of the package can be
    timed this way (``--compare``)."""
    import ctypes

    import torch

    from srt_tpu_torch.kernels import build

    lib = build.load_library()
    orig = getattr(lib, entry)
    blobs = []

    def capture(addr, stream):
        blobs.append(ctypes.create_string_buffer(ctypes.string_at(addr, size),
                                                 size))
        return orig(addr, stream)

    setattr(lib, entry, capture)
    try:
        held = [call(), call()]
    finally:
        setattr(lib, entry, orig)
    stream = torch.cuda.current_stream().cuda_stream

    def two():
        for b in blobs:
            if orig(ctypes.addressof(b), stream):
                raise RuntimeError(f"{entry} launch failed")
    ms = time_ms(two, max(reps // 2, 1)) / 2
    del held
    return ms


def kernel_registers(report: str, kernel: str) -> dict:
    """``ptxas``' registers of each instantiation of the CUDA kernel
    ``kernel``, keyed by its template's bool arguments as digits (B1's
    ``kMoving kRich``, B2's ``kExt kMoving kRich``), from the build's
    ``-Xptxas -v`` report."""
    import re
    mangled = f"{len(kernel)}{kernel}"
    out, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and mangled in entry:
            key = "".join(re.findall(r"Lb(\d)E", entry)) or "-"
            out[key] = int(m.group(1))
            entry = None
    return out


def b1_wavefront(inp, spec, dev, cursor: int) -> dict:
    """A mid-flight ``LANES``-lane B1 wavefront: the work cursor at
    ``cursor``, three plain bounces, then a seeded half of the lanes
    marked finished."""
    import numpy as np
    import torch

    from srt_tpu_torch.kernels import bounce as kb

    mid = kb.new_wavefront(LANES, dev)
    mid["cursor"].fill_(cursor)
    for _ in range(3):
        kb.regen_bounce_reference(inp, mid, spec)
    half = torch.from_numpy(np.random.default_rng(0).random(LANES) < 0.5)
    mid["alive"][half.to(dev)] = 0
    mid["dead"].copy_(kb.count_dead(mid["alive"]))
    return mid


def b1_launch_ms(inp, st0, spec, reps: int) -> float:
    """Milliseconds per bare B1 launch from a copy of ``st0``."""
    import ctypes

    from srt_tpu_torch.kernels import bounce as kb

    st = clone(st0)
    return bare_launch_ms("srt_regen_bounce", ctypes.sizeof(kb._Args),
                          lambda: kb.regen_bounce(inp, st, spec), reps)


def phase_regen_kernel(scene, cam, dev) -> dict:
    """Phase 3: kernel B1 against its plain version."""
    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, render_regen
    from srt_tpu_torch.core.sobol import sobol_points
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    flags = SceneFlags.of(scene)
    spec = kb.RegenSpec(width=512, height=512, spp=16, max_depth=50,
                        rr_start=1 << 30, pdf_floor=1e-9, seed=0)
    jitter = torch.from_numpy(sobol_points(16, 2).astype(np.float32))
    inp = kb.RegenInputs(scene, flags, cam, jitter)
    mid = b1_wavefront(inp, spec, dev, spec.total_work // 2)  # the spheres
    dead0 = float((mid["alive"] == 0).float().mean())
    st_k, st_p = clone(mid), clone(mid)
    kb.regen_bounce(inp, st_k, spec)
    kb.regen_bounce_reference(inp, st_p, spec)
    torch.cuda.synchronize()
    for k in ("salt", "pix", "depth", "cursor"):
        if not torch.equal(st_k[k], st_p[k]):
            bad = int((st_k[k] != st_p[k]).sum())
            raise AssertionError(f"kernel {k} differs on {bad} lanes")
    fin_mismatch = float((st_k["fin"] != st_p["fin"]).float().mean())
    if fin_mismatch > contract.ALIVE_MISMATCH:
        raise AssertionError(f"fin mismatch {fin_mismatch}")
    m = contract.check_bounce(contract.wavefront_arrays(st_p),
                              contract.wavefront_arrays(st_k))
    log(f"[bounce] {LANES} lanes, {dead0:.3f} dead before the step: ints "
        f"exact, fin mismatch {fin_mismatch}, {json.dumps(m)}")

    plain_ms = [time_bounces(kb.regen_bounce_reference, inp, mid, spec, 10)]
    kern_ms = [b1_launch_ms(inp, mid, spec, 50) for _ in range(2)]
    wrapped_ms = [time_bounces(kb.regen_bounce, inp, mid, spec, 50)
                  for _ in range(2)]
    plain_ms.append(time_bounces(kb.regen_bounce_reference, inp, mid,
                                 spec, 10))
    log(f"[bounce] ms per bounce at {LANES} lanes: kernel {kern_ms} (bare "
        f"launches; {wrapped_ms} through regen_bounce), plain {plain_ms}")
    from srt_tpu_torch.kernels import build
    report = build.ptxas_report()
    log(f"[bounce] ptxas registers of B1 by kMoving kRich "
        f"{json.dumps(kernel_registers(report, 'regen_bounce_kernel'))}, of "
        f"B2 by kExt kMoving kRich "
        f"{json.dumps(kernel_registers(report, 'bounce_kernel'))}")

    small = RenderConfig(width=64, height=64, spp=4, max_depth=8,
                         wavefront=LANES)
    img_k = render_regen(scene, cam, small).cpu().numpy()
    img_p = render_regen(scene, cam, small, plain=True).cpu().numpy()
    mi = contract.check_image(img_k, img_p)
    log(f"[image] 64x64x4 depth 8 kernel vs plain: {json.dumps(mi)}")

    # what the timed step needs: every lane reads 68 B and writes 12 B
    # (depth, alive, finished); a live lane writes 48 B of state, a
    # regenerated one 12 B more; live lanes sweep and shade
    remaining = spec.total_work - int(mid["cursor"][0])
    n_live = min(LANES, int((mid["alive"] != 0).sum())
                 + min(remaining, int((mid["alive"] == 0).sum())))
    n_new = n_live - int((mid["alive"] != 0).sum())
    ms_bound, by = bound(LANES * (68 + 12) + n_live * 48 + n_new * 12,
                         n_live * (scene.n_spheres * OPS_SPHERE
                                   + scene.n_rects * OPS_RECT + OPS_SHADE))
    return {"name": "regen_bounce", "route": "cuda",
            "source": "srt_tpu_torch/csrc/regen_bounce.cu",
            "replaces": "srt_tpu/pallas/bounce.py:1067",
            "max_abs_err": m["radiance"]["max"], "ms": min(kern_ms),
            "plain_ms": min(plain_ms), "bound_ms": ms_bound,
            "bound_by": by, "library_ms": None}


def phase_render(scene, cam, ppm) -> int:
    """Phase 4: the render path through B1; returns its launches."""
    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, render_regen
    from srt_tpu_torch.kernels import bounce as kb

    cfg = RenderConfig(**MAIN)
    t0 = time.time()
    render_regen(scene, cam, cfg)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    kb.LAUNCHES = 0
    runs = [render_regen(scene, cam, cfg, metrics=True)
            for _ in range(MAIN_REPS)]
    launches = kb.LAUNCHES
    bounces = sum(m.bounces for _, m in runs)
    if launches != bounces or launches == 0:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{bounces} bounces")
    rates = sorted(m.primary_rays_per_sec for _, m in runs)
    for img, met in runs:
        img = img.cpu().numpy()
        nan_pixels = int(np.isnan(img).sum())
        mean = float(img.mean())
        if not np.isfinite(img).all() or nan_pixels or not 0.1 < mean < 0.5:
            raise AssertionError(f"main image: mean {mean}, "
                                 f"nan {nan_pixels}")
    log(f"[main] ball_scenes 512x512x16 depth 50, {MAIN_REPS} renders: "
        f"median {rates[len(rates) // 2]:.1f} primary rays/s (all {rates}), "
        f"first render {warmup_s:.3f}s, mean {mean:.5f}, nan_pixels "
        f"{nan_pixels}, {json.dumps(met.to_dict())}")
    if ppm:
        from srt_tpu_torch.io.image import write_ppm
        write_ppm(ppm, np.sqrt(np.clip(img, 0.0, 1.0)))
    return launches


def train_state(scene, cam, flags, tables, spec, dev,
                bounces: int = 3, size: dict = TRAIN) -> dict:
    """A mid-flight 16,384-lane wavefront of the train engine: lanes start
    from ``render_pixels``' camera rays (``size``'s width and spp, 256x256
    and 4 by default, seed 0, taken in a seeded order), take ``bounces``
    plain bounces, and a lane that ends is refilled from the ray queue, as
    the engine does; then a seeded half of the lanes is marked dead."""
    import numpy as np
    import torch

    from srt_tpu_torch.diff.inverse import camera_rays
    from srt_tpu_torch.kernels import bounce as kb

    w, spp = size["width"], size["spp"]
    rays, salt = camera_rays(cam, torch.arange(w * w, device=dev), spp,
                             width=w, height=w, seed=0)
    r = np.random.default_rng(1)
    queue = torch.from_numpy(r.permutation(w * w * spp)).to(dev)
    n = TRAIN_LANES
    st = dict(o=torch.zeros((n, 3), device=dev),
              d=torch.zeros((n, 3), device=dev),
              time=torch.zeros((n,), device=dev),
              beta=torch.zeros((n, 3), device=dev),
              radiance=torch.zeros((n, 3), device=dev),
              alive=torch.zeros((n,), dtype=torch.bool, device=dev),
              salt=torch.zeros((n,), dtype=torch.int32, device=dev),
              depth=torch.zeros((n,), dtype=torch.int32, device=dev))
    cursor = 0
    for i in range(bounces + 1):
        lanes = torch.nonzero(~st["alive"])[:, 0]
        src = queue[cursor:cursor + lanes.shape[0]]
        cursor += lanes.shape[0]
        for k, v in (("o", rays[0]), ("d", rays[1]), ("time", rays[2]),
                     ("salt", salt)):
            st[k][lanes] = v[src]
        st["beta"][lanes] = 1.0
        st["radiance"][lanes] = 0.0
        st["depth"][lanes] = 0
        st["alive"][lanes] = True
        if i < bounces:
            with torch.no_grad():
                st = kb.bounce_step_ref(scene, flags, tables["mat"], st,
                                        spec)
            st["alive"] = st["alive"] & (st["depth"] < spec.max_depth)
    st["alive"] = st["alive"] & torch.from_numpy(r.random(n) >= 0.5).to(dev)
    return {k: v.contiguous() for k, v in st.items()}


def phase_train_kernels(scene, cam, dev) -> list:
    """Phase 5: kernels B2 and B5 against their plain versions."""
    import numpy as np
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=TRAIN["max_depth"])
    st = train_state(scene, cam, flags, tables, spec, dev)
    n = TRAIN_LANES
    n_live = int(st["alive"].sum())

    # B2: one launch against the plain step
    out_k = kb.bounce_fwd(scene, flags, tables, st, spec)
    out_p = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    torch.cuda.synchronize()
    if not torch.equal(out_k["depth"], out_p["depth"]):
        raise AssertionError("B2 depth differs")

    def arrays(o):
        return {"alive": o["alive"].cpu().numpy(),
                **{k: o[k].cpu().numpy() for k in ("d", "beta", "radiance")}}
    m2 = contract.check_bounce(arrays(out_p), arrays(out_k))
    err2 = max(m2[k]["max"] for k in ("d", "beta", "radiance"))
    log(f"[train-fwd] {n} lanes, {n_live} live: depth exact, "
        f"{json.dumps(m2)}")

    # B5: one launch against torch.autograd of the plain step. The
    # cotangent of o, d and beta is zero where the step ends the path, as
    # in the engine: a finished lane's o, d, beta are never read again
    # (the kernels leave them as they were, the plain step overwrites beta)
    r = np.random.default_rng(2)
    keep = out_p["alive"][:, None].float()
    ct = {k: torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32))
          .to(dev) for k in kbb.ROWS}
    for k in ("o", "d", "beta"):
        ct[k] = ct[k] * keep
    g_k, dmat_k = kbb.bounce_bwd(scene, flags, tables, st, ct, spec)
    g_p, dmat_p = kbb.bounce_bwd_reference(scene, flags, tables["mat"], st,
                                           ct, spec)
    torch.cuda.synchronize()
    m5 = contract.check_grads({k: g_p[k].cpu().numpy() for k in kbb.ROWS},
                              {k: g_k[k].cpu().numpy() for k in kbb.ROWS})
    a, b = dmat_p.cpu().numpy(), dmat_k.cpu().numpy()
    scale = float(np.abs(a).max())
    mat_rel = float(np.abs(a - b).max() / max(scale, 1e-30))
    if not np.isfinite(b).all() or not np.allclose(
            b, a, rtol=contract.GRAD_RTOL, atol=1e-4 * scale):
        raise AssertionError(f"B5 material sums differ: max rel {mat_rel}")
    log(f"[train-bwd] {n} lanes: d_state {json.dumps(m5)}, (M,14) sums max "
        f"|d| / max|ref| {mat_rel:.3e}")

    # kernel times: the bare launch on arguments built once, so the
    # wrapper's checks and allocations stay out of the timed loop
    from srt_tpu_torch.kernels.build import launch
    reps_k, reps_p = 200, 5
    fargs, _ = kb.fwd_args(scene, flags, tables, st, spec)
    bargs, _ = kbb.bwd_args(scene, flags, tables, st, ct, spec)
    fwd_ms = [time_ms(lambda: launch("srt_bounce", fargs, dev), reps_k)
              for _ in range(2)]
    fwd_plain = time_ms(lambda: kb.bounce_step_ref(
        scene, flags, tables["mat"], st, spec), reps_p)
    bwd_ms = [time_ms(lambda: launch("srt_bounce_bwd", bargs, dev), reps_k)
              for _ in range(2)]
    bwd_plain = time_ms(lambda: kbb.bounce_bwd_reference(
        scene, flags, tables["mat"], st, ct, spec), reps_p)
    log(f"[train-kernels] ms per launch at {n} lanes: B2 {fwd_ms} (plain "
        f"step {fwd_plain}), B5 {bwd_ms} (plain autograd {bwd_plain})")

    sweep = scene.n_spheres * OPS_SPHERE + scene.n_rects * OPS_RECT
    fwd_bound = bound(n * (57 + 53), n_live * (sweep + OPS_SHADE))
    bwd_bound = bound(n * (105 + 92),
                      n_live * (sweep + VJP_SHADE * OPS_SHADE))
    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": "bounce", "source": "srt_tpu_torch/csrc/bounce.cu",
         "replaces": "srt_tpu/pallas/bounce.py:1067", "max_abs_err": err2,
         "ms": min(fwd_ms), "plain_ms": fwd_plain, "bound_ms": fwd_bound[0],
         "bound_by": fwd_bound[1], **common},
        {"name": "bounce_bwd", "source": "srt_tpu_torch/csrc/bounce_bwd.cu",
         "replaces": "srt_tpu/pallas/bounce_bwd.py:76",
         "max_abs_err": m5["max_abs"], "ms": min(bwd_ms),
         "plain_ms": bwd_plain, "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1], **common}]


def train_walls(scene, cam, params: dict, size: dict, dev, steps: int,
                reset=None) -> tuple:
    """``make_train_step`` on ``scene`` at ``size`` (width, spp, depth)
    with phase 6's engine, optimiser and target: one step (seed 0) to warm
    up, then ``reset()`` when given, then ``steps`` timed steps with seeds
    1, 2, ... Returns the step, the warm-up seconds, the losses (the
    warm-up's first) and the step walls in seconds."""
    import torch

    from srt_tpu_torch import make_train_step

    w = size["width"]
    step = make_train_step(scene, cam, params, width=w, height=w,
                           spp=size["spp"], max_depth=size["max_depth"],
                           lr=TRAIN_LR, engine_kw=TRAIN_ENGINE, device=dev)
    target = torch.full((w, w, 3), TRAIN_TARGET, device=dev)
    t0 = time.time()
    losses = [float(step(target, 0))]
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    if reset is not None:
        reset()
    walls = []
    for seed in range(1, steps + 1):
        t0 = time.time()
        loss = step(target, seed)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        losses.append(float(loss))
    return step, warmup_s, losses, walls


def phase_train(scene, cam, dev) -> tuple[int, int]:
    """Phase 6: the train path; returns the B2 and B5 launches of the
    timed steps."""
    import numpy as np

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.render.regen_scan import steps_for

    w, spp = TRAIN["width"], TRAIN["spp"]
    rays = w * w * spp

    def reset():
        kb.LAUNCHES_FWD = kbb.LAUNCHES_BWD = 0
    step, warmup_s, (loss0, *losses), walls = train_walls(
        scene, cam, {"tex_color": scene.tex_color}, TRAIN, dev, TRAIN_STEPS,
        reset)
    fwd, bwd = kb.LAUNCHES_FWD, kbb.LAUNCHES_BWD
    n_steps = steps_for(rays, TRAIN_ENGINE["wavefront"],
                        TRAIN_ENGINE["depth_budget"], TRAIN["max_depth"],
                        drain=TRAIN_ENGINE["drain"])
    if not fwd == bwd == n_steps * TRAIN_STEPS:
        raise AssertionError(f"{fwd} forward and {bwd} backward launches "
                             f"for {TRAIN_STEPS} steps of {n_steps} bounces")
    if not all(np.isfinite([loss0] + losses)):
        raise AssertionError(f"losses {loss0} {losses}")
    grad = step.params["tex_color"].grad.cpu().numpy()
    const = sorted(set(scene.mat_tex.tolist())
                   & set(np.flatnonzero(scene.tex_type.cpu().numpy() == 0)
                         .tolist()))
    if not np.isfinite(grad).all() or not (np.abs(grad[const]).sum(-1)
                                           > 0).all():
        raise AssertionError(f"tex_color gradient {grad} (rows {const})")
    med = sorted(walls)[len(walls) // 2]
    log(f"[train] ball_scenes {w}x{w}x{spp} depth {TRAIN['max_depth']}, "
        f"{n_steps} bounces a step: median {rays / med:.1f} train-step "
        f"rays/s (step walls {walls} s), warm-up step {warmup_s:.3f} s, "
        f"losses {[loss0] + losses}, {fwd} B2 and {bwd} B5 launches, "
        f"tex_color gradient finite, nonzero on rows {const}")
    return fwd, bwd


def tri_wavefront(scene, cam, dev, row: int = 256) -> tuple:
    """A mid-flight 65,536-lane wavefront of the triangle render path (the
    work cursor at image row ``row``, mid-image by default, three plain
    bounces, a lane that ends taking the next work item), then a seeded
    half of the lanes marked dead.
    Returns the bounce's state (B2's layout), the render's inputs, and the
    wavefront's first rays (the camera rays, ``o`` and ``d``)."""
    import numpy as np
    import torch

    from srt_tpu_torch.core.sobol import sobol_points
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.render.intersect import intersect_tris_any
    from srt_tpu_torch.scene.ir import SceneFlags

    flags = SceneFlags.of(scene)
    spec = kb.RegenSpec(width=512, height=512, spp=16, max_depth=50,
                        rr_start=1 << 30, pdf_floor=1e-9, seed=0)
    step = kb.StepSpec(max_depth=50)
    inp = kb.RegenInputs(scene, flags, cam, torch.from_numpy(
        sobol_points(16, 2).astype(np.float32)))
    n = LANES
    st = dict(o=torch.zeros((n, 3), device=dev),
              d=torch.zeros((n, 3), device=dev),
              time=torch.zeros((n,), device=dev),
              beta=torch.zeros((n, 3), device=dev),
              radiance=torch.zeros((n, 3), device=dev),
              salt=torch.zeros((n,), dtype=torch.int32, device=dev),
              depth=torch.zeros((n,), dtype=torch.int32, device=dev),
              alive=torch.zeros((n,), dtype=torch.bool, device=dev),
              pix=torch.zeros((n,), dtype=torch.int64, device=dev))
    cursor = torch.full((), row * spec.width * spec.spp, dtype=torch.int64,
                        device=dev)
    for i in range(4):
        state, take, pix = kb.regenerate(inp, spec, st, cursor)
        cursor = cursor + take.sum()
        state["salt"] = state["salt"].to(torch.int32)
        if i == 0:
            first = {k: state[k].contiguous() for k in ("o", "d")}
        if i == 3:
            break
        tri = intersect_tris_any(scene, state["o"], state["d"])
        nxt = kb.bounce_step_ref(scene, flags, inp.tables["mat"], state,
                                 step, tri)
        st = dict(nxt, alive=nxt["alive"] & (nxt["depth"] < 50), pix=pix)
    half = torch.from_numpy(np.random.default_rng(3).random(n) < 0.5)
    state["alive"] = state["alive"] & ~half.to(dev)
    return {k: v.contiguous() for k, v in state.items()}, inp, step, first


def ground_field(dev) -> tuple:
    """``final``'s ground (``srt_tpu/scene/library.py:418-430``): 20x20
    boxes of 100 x 100, heights from ``np.random.default_rng(1)``, as
    4,800 BVH triangles; and 65,536 rays of ``final``'s camera (``:460``)
    through seeded film points."""
    import numpy as np
    import torch

    from srt_tpu_torch.core import rng
    from srt_tpu_torch.render.camera import Camera
    from srt_tpu_torch.scene.build import SceneBuilder

    draws = np.random.default_rng(1)
    b = SceneBuilder()
    b.lambertian(b.constant((0.73, 0.73, 0.73)))
    ground = b.lambertian(b.constant((0.48, 0.83, 0.53)))
    for i in range(20):
        for j in range(20):
            x0, z0 = -1000.0 + i * 100.0, -1000.0 + j * 100.0
            y1 = 100.0 * (draws.random() + 0.01)
            b.box((x0, 0.0, z0), (x0 + 100.0, y1, z0 + 100.0), ground,
                  as_tris=True)
    scene = b.build(dev)
    cam = Camera.look_at((478, 278, -600), (278, 278, 0), vfov=40.0,
                         aspect=1.0, aperture=0.0, focus_dist=10.0,
                         device=dev)
    r = np.random.default_rng(5)
    s, t = (torch.from_numpy(r.random(LANES).astype(np.float32)).to(dev)
            for _ in range(2))
    salt = rng.create_salt(0, torch.arange(LANES, device=dev),
                           torch.zeros(LANES, dtype=torch.int64, device=dev))
    o, d, _ = cam.rays(s, t, rng.uniform(salt, 32), rng.uniform(salt, 33),
                       rng.uniform(salt, 34))
    return scene, o.contiguous(), d.contiguous()


def check_tri_kernel(label: str, scene, o, d) -> dict:
    """Phase 7 on one input: B3 against the plain walk; times and bound."""
    import torch

    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.kernels.build import launch

    tables = ki.pack_tables(scene)
    t, u, v, idx = ki.intersect_tris(scene, tables, o, d)
    pt, pu, pv, pidx, visits, tests = ki.intersect_tris_reference(
        scene, o, d, stats=True)
    torch.cuda.synchronize()
    hit = pt < 3e38
    if not torch.equal(t < 3e38, hit):
        raise AssertionError(f"B3 {label}: hit mask differs on "
                             f"{int(((t < 3e38) != hit).sum())} rays")
    if not torch.equal(idx.long()[hit], pidx[hit]):
        raise AssertionError(f"B3 {label}: triangle index differs on "
                             f"{int((idx.long() != pidx)[hit].sum())} rays")
    if not bool(hit.any()):
        raise AssertionError(f"B3 {label}: no ray hits a triangle")
    err = {k: float((a - b)[hit].abs().max())
           for k, a, b in (("t", t, pt), ("u", u, pu), ("v", v, pv))}
    if err["t"] > TRI_T_ATOL or max(err["u"], err["v"]) > TRI_UV_ATOL:
        raise AssertionError(f"B3 {label}: hits beyond |dt| <= {TRI_T_ATOL}, "
                             f"|du|, |dv| <= {TRI_UV_ATOL}: {err}")
    args, _ = ki.kernel_args(tables, o, d)
    kern_ms = [time_ms(lambda: launch("srt_intersect_tris", args, o.device),
                       200) for _ in range(2)]
    plain_ms = time_ms(lambda: ki.intersect_tris_reference(scene, o, d), 3)
    n = o.shape[0]
    n_bytes = n * (24 + 16) + 4 * (tables["nodes"].numel()
                                   + tables["tris"].numel())
    ops = (n * OPS_RAY + int(visits.sum()) * OPS_SLAB
           + int(tests.sum()) * OPS_TRI)
    ms_bound, by = bound(n_bytes, ops)
    log(f"[tris-{label}] {n} rays, {scene.n_tris} triangles, "
        f"{scene.n_bvh_nodes} nodes: hits {int(hit.sum())} and indices "
        f"equal, max |dt| {err['t']:.3e} |du| {err['u']:.3e} |dv| "
        f"{err['v']:.3e}; per ray {float(visits.float().mean()):.2f} node "
        f"visits, {float(tests.float().mean()):.2f} triangle tests; ms per "
        f"launch {kern_ms}, plain {plain_ms:.3f}, bound {ms_bound:.6f} "
        f"({by})")
    return {"max_abs_err": max(err.values()), "ms": min(kern_ms),
            "plain_ms": plain_ms, "bound_ms": ms_bound, "bound_by": by}


def phase_tri_kernels(scene, cam, dev) -> tuple[dict, dict]:
    """Phases 7 and 8: B3 on both inputs, B2's external-hit mode on (a)."""
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.scene.ir import SceneFlags

    st, inp, step, _ = tri_wavefront(scene, cam, dev)
    b3 = check_tri_kernel("cornell", scene, st["o"], st["d"])
    check_tri_kernel("final-ground", *ground_field(dev))

    tri = ki.intersect_tris(scene, ki.pack_tables(scene), st["o"], st["d"])
    b2 = check_b2("cornell", scene, SceneFlags.of(scene),
                          inp.tables, st, step, tri)
    b3.update(name="intersect_tris", route="cuda",
              source="srt_tpu_torch/csrc/intersect_tris.cu",
              replaces="srt_tpu/pallas/intersect.py:148", library_ms=None)
    return b3, b2


def check_b2(label: str, scene, flags, tables, st, step,
             tri=None) -> dict:
    """One launch of B2 against the plain step under the per-bounce
    contract, depth exact; times and bound. With ``tri``, the triangles'
    closest hit, its external-hit mode (phases 8, 11, 16, 18), else the
    plain bounce of a train state (phases 19, 20)."""
    import torch
    from _torch_census import bounce_census

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels.build import launch
    from srt_tpu_torch.utils import contract

    dev = st["o"].device
    out_k = kb.bounce_fwd(scene, flags, tables, st, step, tri)
    out_p = kb.bounce_step_ref(scene, flags, tables["mat"], st, step, tri)
    torch.cuda.synchronize()
    if not torch.equal(out_k["depth"], out_p["depth"]):
        raise AssertionError(f"B2 {label}: depth differs")
    keys = ("alive", "d", "beta", "radiance")
    m = contract.check_bounce({k: out_p[k].cpu().numpy() for k in keys},
                              {k: out_k[k].cpu().numpy() for k in keys})
    n = st["o"].shape[0]
    n_live = int(st["alive"].sum())
    n_tri = 0 if tri is None else int((st["alive"] & (tri[0] < 3e38)).sum())
    fargs, _ = kb.fwd_args(scene, flags, tables, st, step, tri)
    kern_ms = [time_ms(lambda: launch("srt_bounce", fargs, dev), 200)
               for _ in range(2)]
    plain_ms = time_ms(lambda: kb.bounce_step_ref(
        scene, flags, tables["mat"], st, step, tri), 5)
    c = bounce_census(scene, st["o"], st["d"], st["time"], st["salt"],
                      st["depth"], st["alive"], tri)
    # a lane reads 57 B, 73 B with a triangle hit, and writes 53 B
    ms_bound, by = bound(n * (57 + (0 if tri is None else 16) + 53),
                         shade_ops(scene, flags, c) + n_tri * OPS_TRI_HIT)
    log(f"[bounce-{label}] {n} lanes, {n_live} live, {n_tri} on a "
        f"triangle: depth exact, {json.dumps(m)}; shaded {json.dumps(c)}; "
        f"ms per launch {kern_ms}, plain {plain_ms:.3f}, bound "
        f"{ms_bound:.6f} ({by})")
    return {"max_abs_err": max(m[k]["max"] for k in keys[1:]),
            "ms": min(kern_ms), "plain_ms": plain_ms, "bound_ms": ms_bound,
            "bound_by": by, "census": c}


def shade_ops(scene, flags, c: dict) -> int:
    """Operations of one bounce of the lanes ``bounce_census`` counted: the
    sweep and the media on every live lane, the shading by family."""
    n_sph_lights = sum(1 for k in flags.light_kinds if k == 1)
    sphere = OPS_SPHERE_MOVING if flags.moving else OPS_SPHERE
    return (c["live"] * (scene.n_spheres * sphere + scene.n_rects * OPS_RECT
                         + scene.n_media * OPS_MEDIUM)
            + c["diffuse"] * (OPS_SHADE + n_sph_lights * OPS_SPHERE_PDF)
            + c["sphere_light_sample"] * OPS_SPHERE_SAMPLE
            + c["specular"] * OPS_SPECULAR + c["checker"] * OPS_CHECKER
            + c["marble"] * OPS_MARBLE + c["image"] * OPS_IMAGE)


def phase_tri_render(scene, cam) -> tuple[int, int]:
    """Phase 9: the triangle render path; returns the B3 and B2 launches
    of the timed renders."""
    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, render_regen
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.utils import contract

    small = RenderConfig(width=64, height=64, spp=4, max_depth=8,
                         wavefront=LANES)
    img_k = render_regen(scene, cam, small).cpu().numpy()
    img_p = render_regen(scene, cam, small, plain=True).cpu().numpy()
    mi = contract.check_image(img_k, img_p)
    log(f"[tri-image] cornell_boxes 64x64x4 depth 8 kernels vs plain: "
        f"{json.dumps(mi)}")

    cfg = RenderConfig(**MAIN)
    t0 = time.time()
    render_regen(scene, cam, cfg)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    ki.LAUNCHES = kb.LAUNCHES_FWD = kb.LAUNCHES = 0
    runs = []
    for _ in range(TRI_MAIN_REPS):
        img, met = render_regen(scene, cam, cfg, metrics=True)
        runs.append((img.cpu().numpy(), met))
    b3, b2, b1 = ki.LAUNCHES, kb.LAUNCHES_FWD, kb.LAUNCHES
    bounces = sum(m.bounces for _, m in runs)
    if not b3 == b2 == bounces or bounces == 0 or b1:
        raise AssertionError(f"{b3} B3 and {b2} B2 launches ({b1} B1) for "
                             f"{bounces} bounces")
    for img, met in runs:
        nan_pixels = int(np.isnan(img).sum())
        mean = float(img.mean())
        if not np.isfinite(img).all() or nan_pixels or not 0.05 < mean < 0.5:
            raise AssertionError(f"cornell_boxes image: mean {mean}, "
                                 f"nan {nan_pixels}")
    rates = sorted(m.primary_rays_per_sec for _, m in runs)
    log(f"[tri-main] cornell_boxes {MAIN['width']}x{MAIN['height']}x"
        f"{MAIN['spp']} depth {MAIN['max_depth']}, {TRI_MAIN_REPS} "
        f"renders: median {rates[len(rates) // 2]:.1f} primary rays/s (all "
        f"{rates}), first render {warmup_s:.3f}s, mean {mean:.5f}, "
        f"nan_pixels {nan_pixels}, {b3} B3 and {b2} B2 launches for "
        f"{bounces} bounces, {json.dumps(met.to_dict())}")
    return b3, b2


def teapot(dev):
    """Phase 10's scene: ``teapot_scene`` at divs=100 on the card, after
    the native builder's compile, with the host build's seconds a step as
    the builder records them (``info["host_s"]``)."""
    import warnings

    from srt_tpu_torch import get_scene, native

    native.get_lib()      # any first-use compile stays out of the timing
    t0 = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, info = get_scene("teapot_scene", device=dev,
                                     divs=TEAPOT_DIVS)
    log(f"[teapot] {scene.n_tris} triangles, {scene.n_bvh_nodes} BVH nodes, "
        f"{scene.top_skip.shape[0]} top-tree nodes, {scene.cl_tris.shape[0]} "
        f"clusters: host build seconds {json.dumps(info['host_s'])}, "
        f"get_scene {time.time() - t0:.3f}s; skipped {info.get('skipped')}")
    return scene, cam


def check_big_kernel(label: str, scene, big: dict, single: dict, o,
                     d) -> dict:
    """Phase 10 on one input: B4 against the plain two-level walk and
    against B3 (``big`` and ``single`` are their tables); the times of all
    three and B4's bound."""
    import torch

    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.kernels.build import launch

    t, u, v, idx = ki.intersect_tris_big(scene, big, o, d)
    pt, pu, pv, pidx, top_v, cl_v, tests, seen = \
        ki.intersect_tris_big_reference(scene, o, d, stats=True)
    b3 = ki.intersect_tris(scene, single, o, d)
    torch.cuda.synchronize()
    hit = pt < 3e38
    for name, (kt, kidx) in (("B4", (t, idx)), ("B3", (b3[0], b3[3]))):
        if not torch.equal(kt < 3e38, hit):
            raise AssertionError(f"{name} {label}: hit mask differs on "
                                 f"{int(((kt < 3e38) != hit).sum())} rays")
        if not torch.equal(kidx.long()[hit], pidx[hit]):
            raise AssertionError(f"{name} {label}: triangle index differs "
                                 f"on {int((kidx.long() != pidx)[hit].sum())}"
                                 " rays")
    if not bool(hit.any()):
        raise AssertionError(f"B4 {label}: no ray hits a triangle")
    err = {k: float((a - b)[hit].abs().max())
           for k, a, b in (("t", t, pt), ("u", u, pu), ("v", v, pv))}
    if err["t"] > TRI_T_ATOL or max(err["u"], err["v"]) > TRI_UV_ATOL:
        raise AssertionError(f"B4 {label}: hits beyond |dt| <= {TRI_T_ATOL}, "
                             f"|du|, |dv| <= {TRI_UV_ATOL}: {err}")
    vs_b3 = max(float((a - b)[hit].abs().max())
                for a, b in zip((t, u, v), b3[:3]))
    args, _ = ki.big_kernel_args(big, o, d)
    args3, _ = ki.kernel_args(single, o, d)
    kern_ms, b3_ms = [], []
    for _ in range(2):
        kern_ms.append(time_ms(lambda: launch("srt_intersect_big", args,
                                              o.device), 50))
        b3_ms.append(time_ms(lambda: launch("srt_intersect_tris", args3,
                                            o.device), 50))
    plain_ms = time_ms(lambda: ki.intersect_tris_big_reference(scene, o, d),
                       2)
    # bytes: the rays (o, d in; t, u, v, idx out) and each 36-byte record
    # that some ray read (top-tree nodes, cluster nodes, triangles)
    n, nc = o.shape[0], scene.cl_tris.shape[0]
    n_read = [int(m.sum()) for m in seen]
    entered = int(seen[1].view(nc, -1).any(1).sum())
    n_bytes = n * (24 + 16) + 36 * sum(n_read)
    ops = (n * OPS_RAY + int((top_v + cl_v).sum()) * OPS_SLAB
           + int(tests.sum()) * OPS_TRI)
    ms_bound, by = bound(n_bytes, ops)
    log(f"[big-{label}] {n} rays, {scene.n_tris} triangles in {nc} clusters "
        f"({entered} entered): hits {int(hit.sum())} and indices equal, max "
        f"|dt| {err['t']:.3e} |du| {err['u']:.3e} |dv| {err['v']:.3e}; B3 on "
        f"the same rays: hits and indices equal, max |d(t,u,v)| "
        f"{vs_b3:.3e}; per ray {float(top_v.float().mean()):.2f} top visits, "
        f"{float(cl_v.float().mean()):.2f} cluster-node visits, "
        f"{float(tests.float().mean()):.2f} triangle tests (max "
        f"{int((top_v + cl_v).max())} visits); records read: {n_read[0]} "
        f"top nodes, {n_read[1]} cluster nodes, {n_read[2]} triangles, "
        f"{n_bytes} bytes with the rays; ms per launch B4 {kern_ms}, B3 "
        f"{b3_ms}, plain {plain_ms:.3f}, bound {ms_bound:.6f} ({by})")
    return {"max_abs_err": max(err.values()), "ms": min(kern_ms),
            "plain_ms": plain_ms, "bound_ms": ms_bound, "bound_by": by,
            "b3_ms": min(b3_ms)}


def phase_teapot_kernels(scene, cam, dev) -> tuple[dict, dict]:
    """Phases 10 and 11: B4 on the camera rays and on the wavefront after
    three plain bounces; B2's external-hit mode with the specular branch
    and the media sweep against its plain version on the latter. B4's
    entry in the kernels line is the bounced wavefront's, whose rays are
    what the render's bounces look like."""
    import torch

    from srt_tpu_torch.core import rng
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.kernels.build import launch
    from srt_tpu_torch.materials.materials import is_specular
    from srt_tpu_torch.render.integrator import apply_media
    from srt_tpu_torch.render.intersect import intersect_scene
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    # the record packing every render_regen on the scene does once
    pack_ms = time_ms(lambda: ki.pack_big_tables(scene), 3)
    big, single = ki.pack_big_tables(scene), ki.pack_tables(scene)
    log(f"[teapot] pack_big_tables {pack_ms:.3f} ms a call")
    # rows 448-455: the teapots' lower edge and the glass sphere's top
    st, inp, step, first = tri_wavefront(scene, cam, dev, row=TEAPOT_ROW)
    b4_cam = check_big_kernel("camera", scene, big, single, first["o"],
                              first["d"])
    b4 = check_big_kernel("bounced", scene, big, single, st["o"], st["d"])
    b4["max_abs_err"] = max(b4["max_abs_err"], b4_cam["max_abs_err"])

    flags, tables = SceneFlags.of(scene), inp.tables
    tri = ki.intersect_tris_big(scene, big, st["o"], st["d"])
    out_k = kb.bounce_fwd(scene, flags, tables, st, step, tri)
    out_p = kb.bounce_step_ref(scene, flags, tables["mat"], st, step, tri)
    torch.cuda.synchronize()
    if not torch.equal(out_k["depth"], out_p["depth"]):
        raise AssertionError("B2 teapot depth differs")
    keys = ("alive", "d", "beta", "radiance")
    m = contract.check_bounce({k: out_p[k].cpu().numpy() for k in keys},
                              {k: out_k[k].cpu().numpy() for k in keys})
    # what the lanes shade this bounce: the hit after the media sweep
    salt = rng.hash_combine(rng.as_word(st["salt"]), rng.as_word(st["depth"]))
    hit = apply_media(scene, st["o"], st["d"], salt,
                      intersect_scene(scene, st["o"], st["d"], tri=tri))
    live = st["alive"] & hit.hit
    spec = live & is_specular(scene, hit.mat)
    medium = live & (hit.mat == int(scene.med_mat[0]))
    n_live, n_spec = int(st["alive"].sum()), int(spec.sum())
    n_tri = int((st["alive"] & (tri[0] < 3e38)).sum())
    if not n_spec or not int(medium.sum()):
        raise AssertionError(f"teapot wavefront: {n_spec} specular lanes, "
                             f"{int(medium.sum())} medium events")
    fargs, _ = kb.fwd_args(scene, flags, tables, st, step, tri)
    kern_ms = [time_ms(lambda: launch("srt_bounce", fargs, dev), 200)
               for _ in range(2)]
    plain_ms = time_ms(lambda: kb.bounce_step_ref(
        scene, flags, tables["mat"], st, step, tri), 5)
    ms_bound, by = bound(LANES * (73 + 53), n_live * (
        scene.n_spheres * OPS_SPHERE + scene.n_rects * OPS_RECT
        + scene.n_media * OPS_MEDIUM) + (n_live - n_spec) * OPS_SHADE
        + n_spec * OPS_SPECULAR + n_tri * OPS_TRI_HIT)
    log(f"[bounce-teapot] {LANES} lanes, {n_live} live, {n_tri} on a "
        f"triangle, {n_spec} specular, {int(medium.sum())} medium events: "
        f"depth exact, {json.dumps(m)}; ms per launch {kern_ms}, plain "
        f"{plain_ms:.3f}, bound {ms_bound:.6f} ({by})")
    b4.update(name="intersect_big", route="cuda",
              source="srt_tpu_torch/csrc/intersect_big.cu",
              replaces="srt_tpu/pallas/intersect_big.py:131", library_ms=None)
    return b4, {"max_abs_err": max(m[k]["max"] for k in keys[1:]),
                "ms": min(kern_ms)}


def phase_teapot_render(scene, cam) -> tuple[int, int]:
    """Phase 12: the teapot render path; returns the B4 and B2 launches of
    the timed renders."""
    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, render_regen
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.utils import contract

    small = RenderConfig(width=32, height=32, spp=4, max_depth=8,
                         wavefront=LANES)
    img_k = render_regen(scene, cam, small).cpu().numpy()
    img_p = render_regen(scene, cam, small, plain=True).cpu().numpy()
    mi = contract.check_image(img_k, img_p)
    log(f"[teapot-image] teapot_scene 32x32x4 depth 8 kernels vs plain: "
        f"{json.dumps(mi)}")

    cfg = RenderConfig(**MAIN)
    t0 = time.time()
    render_regen(scene, cam, cfg)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    ki.LAUNCHES = ki.LAUNCHES_BIG = kb.LAUNCHES_FWD = kb.LAUNCHES = 0
    runs = []
    for _ in range(TRI_MAIN_REPS):
        img, met = render_regen(scene, cam, cfg, metrics=True)
        runs.append((img.cpu().numpy(), met))
    b4, b2, b3, b1 = ki.LAUNCHES_BIG, kb.LAUNCHES_FWD, ki.LAUNCHES, kb.LAUNCHES
    bounces = sum(m.bounces for _, m in runs)
    if not b4 == b2 == bounces or bounces == 0 or b3 or b1:
        raise AssertionError(f"{b4} B4 and {b2} B2 launches ({b3} B3, {b1} "
                             f"B1) for {bounces} bounces")
    for img, met in runs:
        nan_pixels = int(np.isnan(img).sum())
        mean = float(img.mean())
        if (not np.isfinite(img).all() or nan_pixels
                or not TEAPOT_MEAN[0] < mean < TEAPOT_MEAN[1]):
            raise AssertionError(f"teapot_scene image: mean {mean}, nan "
                                 f"{nan_pixels}")
    rates = sorted(m.primary_rays_per_sec for _, m in runs)
    log(f"[teapot-main] teapot_scene {MAIN['width']}x{MAIN['height']}x"
        f"{MAIN['spp']} depth {MAIN['max_depth']}, {TRI_MAIN_REPS} renders: "
        f"median {rates[len(rates) // 2]:.1f} primary rays/s (all {rates}), "
        f"first render {warmup_s:.3f}s, mean {mean:.5f}, nan_pixels "
        f"{nan_pixels}, {b4} B4 and {b2} B2 launches for {bounces} bounces, "
        f"{json.dumps(met.to_dict())}")
    return b4, b2


def moving_spheres_scene(dev):
    """Phase 13's third input: 20 spheres at seeded places in a 50-radius
    env dome, every fourth moving, every fourth flipped (the pattern of
    ``tests/test_pallas.py:116-157``), and 65,536 seeded rays from the
    spheres' region with seeded times."""
    import numpy as np
    import torch

    from srt_tpu_torch.scene.build import SceneBuilder

    r = np.random.default_rng(11)
    b = SceneBuilder()
    m = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    for i in range(20):
        c = r.uniform(-4, 4, 3)
        if i % 4 == 0:
            b.sphere(c, 0.5, m, center1=c + r.uniform(-1, 1, 3))
        else:
            b.sphere(c, 0.5, m, flip=i % 4 == 1)
    b.sphere((0, 0, 0), 50.0, b.diffuse_light(b.constant((1, 1, 1))),
             env=True)
    scene = b.build(dev)
    o = (r.standard_normal((LANES, 3)) * 2).astype(np.float32)
    d = r.standard_normal((LANES, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = r.uniform(0, 1, LANES).astype(np.float32)
    return scene, *(torch.from_numpy(x).to(dev) for x in (o, d, t))


def check_winner(label: str, scene, o, d, time) -> dict:
    """Phase 13 on one input: B6 against its plain version, index equal
    and ``t`` equal to the bit; its time per launch, the plain version's
    and the bound."""
    import torch

    from srt_tpu_torch.kernels import spheres as ks
    from srt_tpu_torch.kernels.bounce import build_tables
    from srt_tpu_torch.kernels.build import launch
    from srt_tpu_torch.scene.ir import SceneFlags

    sph = build_tables(scene, SceneFlags.of(scene))["sph"]
    pt, pidx = ks.sphere_winner_reference(scene, o, d, time)
    hits = int((pidx >= 0).sum())
    if not hits:
        raise AssertionError(f"B6 {label}: no ray hits a sphere")
    t, idx = ks.sphere_winner(scene, sph, o, d, time)
    torch.cuda.synchronize()
    if not torch.equal(idx, pidx):
        raise AssertionError(f"B6 {label}: index differs on "
                             f"{int((idx != pidx).sum())} rays")
    if not torch.equal(t, pt):
        raise AssertionError(f"B6 {label}: t differs on "
                             f"{int((t != pt).sum())} rays, max "
                             f"{float((t - pt).abs().max())}")
    args, _ = ks.kernel_args(sph, o, d, time, 1e-3)
    kern_ms = [time_ms(lambda: launch("srt_sphere_winner", args, o.device),
                       200) for _ in range(2)]
    plain_ms = time_ms(lambda: ks.sphere_winner_reference(scene, o, d, time),
                       5)
    n, s = o.shape[0], scene.n_spheres
    ms_bound, by = bound(n * (28 + 8) + 48 * s, n * s * OPS_SPHERE_MOVING)
    log(f"[winner-{label}] {n} rays, {s} spheres, {hits} hits: indices and "
        f"t equal to the bit; ms per launch {kern_ms}, plain "
        f"{plain_ms:.3f}, bound {ms_bound:.6f} ({by})")
    return {"max_abs_err": 0.0, "ms": min(kern_ms), "plain_ms": plain_ms,
            "bound_ms": ms_bound, "bound_by": by}


def phase_winner(scene, cam, dev) -> dict:
    """Phase 13: B6 on its three inputs; the kernels line takes the train
    wavefront's numbers, the shape the geometry train step gives it."""
    import torch

    from srt_tpu_torch.diff.inverse import camera_rays
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.scene.ir import SceneFlags

    flags = SceneFlags.of(scene)
    spec = kb.StepSpec(max_depth=TRAIN["max_depth"])
    st = train_state(scene, cam, flags, kb.build_tables(scene, flags), spec,
                     dev, bounces=2)
    b6 = check_winner("train", scene, st["o"], st["d"], st["time"])
    w = TRAIN["width"]
    (o, d, t), _ = camera_rays(cam, torch.arange(w * w, device=dev), 1,
                               width=w, height=w, seed=0)
    check_winner("camera", scene, o.contiguous(), d.contiguous(),
                 t.contiguous())
    check_winner("moving", *moving_spheres_scene(dev))
    b6.update(name="sphere_winner", route="cuda",
              source="srt_tpu_torch/csrc/sphere_winner.cu",
              replaces="srt_tpu/pallas/spheres.py:123", library_ms=None)
    return b6


def moved_balls(scene):
    """ball_scenes with every ball moving ``MOVE_Y`` up over the shutter
    interval (the env dome stays)."""
    import dataclasses

    c1 = scene.sph_center0.clone()
    c1[~scene.sph_env, 1] += MOVE_Y
    return dataclasses.replace(scene, sph_center1=c1)


def phase_moving_bounces(scene, cam, dev) -> None:
    """Phase 14: B1 and B2 with kMoving against their plain versions."""
    import numpy as np
    import torch

    from srt_tpu_torch.core.sobol import sobol_points
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    moved = moved_balls(scene)
    flags = SceneFlags.of(moved)
    if not flags.moving:
        raise AssertionError("the moved scene's flags say static")
    spec = kb.RegenSpec(width=512, height=512, spp=16, max_depth=50,
                        rr_start=1 << 30, pdf_floor=1e-9, seed=0)
    inp = kb.RegenInputs(moved, flags, cam, torch.from_numpy(
        sobol_points(16, 2).astype(np.float32)))
    mid = kb.new_wavefront(LANES, dev)
    mid["cursor"].fill_(spec.total_work // 2)
    for _ in range(3):
        kb.regen_bounce_reference(inp, mid, spec)
    st_k, st_p = clone(mid), clone(mid)
    launches = kb.LAUNCHES
    kb.regen_bounce(inp, st_k, spec)
    kb.regen_bounce_reference(inp, st_p, spec)
    torch.cuda.synchronize()
    if kb.LAUNCHES != launches + 1:
        raise AssertionError("B1 did not launch")
    for k in ("salt", "pix", "depth", "cursor"):
        if not torch.equal(st_k[k], st_p[k]):
            raise AssertionError(f"B1 moving: {k} differs")
    m1 = contract.check_bounce(contract.wavefront_arrays(st_p),
                               contract.wavefront_arrays(st_k))

    tables = kb.build_tables(moved, flags)
    step = kb.StepSpec(max_depth=TRAIN["max_depth"])
    st = train_state(moved, cam, flags, tables, step, dev)
    out_k = kb.bounce_fwd(moved, flags, tables, st, step)
    out_p = kb.bounce_step_ref(moved, flags, tables["mat"], st, step)
    torch.cuda.synchronize()
    if not torch.equal(out_k["depth"], out_p["depth"]):
        raise AssertionError("B2 moving: depth differs")
    keys = ("alive", "d", "beta", "radiance")
    m2 = contract.check_bounce({k: out_p[k].cpu().numpy() for k in keys},
                               {k: out_k[k].cpu().numpy() for k in keys})
    # the lerp must matter: the same state with the spheres held static
    static = kb.bounce_step_ref(scene, SceneFlags.of(scene), tables["mat"],
                                st, step)
    moved_lanes = int((static["d"] != out_p["d"]).any(1).sum())
    if not moved_lanes:
        raise AssertionError("moving the balls changed no lane")
    log(f"[moving] balls moving {MOVE_Y} up: B1 {LANES} lanes ints exact, "
        f"{json.dumps(m1)}; B2 {TRAIN_LANES} lanes depth exact, "
        f"{json.dumps(m2)}; {moved_lanes} lanes differ from the static "
        "scene's bounce")


def phase_geom_train(scene, cam, dev) -> tuple[int, int]:
    """Phase 15: ``BounceHybrid``'s per-bounce cotangents (one B2 forward
    and one backward under autograd) against ``torch.autograd`` of the
    plain step with its own sphere sweep, then the geometry train step;
    returns the B2 and B6 launches of the timed steps."""
    import numpy as np
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.kernels import bounce_vjp as kv
    from srt_tpu_torch.kernels import spheres as ks
    from srt_tpu_torch.render.regen_scan import steps_for
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    flags = SceneFlags.of(scene)._replace(moving=True)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=TRAIN["max_depth"])
    st = train_state(scene, cam, flags, tables, spec, dev)
    with torch.no_grad():
        ends = ~kb.bounce_fwd(scene, flags, tables, st, spec)["alive"]
    r = np.random.default_rng(4)
    ct = {k: torch.from_numpy(r.standard_normal((TRAIN_LANES, 3))
                              .astype(np.float32)).to(dev) for k in kbb.ROWS}
    for k in ("o", "d", "beta"):
        ct[k][ends] = 0.0
    geom = {k: getattr(scene, k).clone().requires_grad_()
            for k in GEOM_PARAMS}
    rows = {k: st[k].clone().requires_grad_() for k in kbb.ROWS}
    mat = tables["mat"].clone().requires_grad_()
    launches = ks.LAUNCHES
    # BounceHybrid under autograd, as the train step runs it
    out = kv.bounce_hybrid(scene, flags, dict(tables, mat=mat),
                           dict(st, **rows), spec, geom)
    grads = torch.autograd.grad(
        [out[k] for k in kbb.ROWS],
        [rows[k] for k in kbb.ROWS] + [mat] + list(geom.values()),
        [ct[k] for k in kbb.ROWS])
    got = (dict(zip(kbb.ROWS, grads[:4])), grads[4],
           dict(zip(geom, grads[5:])))
    ref = kbb.replay_vjp(scene, flags, tables["mat"], st, ct, spec, geom)
    torch.cuda.synchronize()
    if ks.LAUNCHES != launches + 1:
        raise AssertionError("the hybrid backward did not launch B6")
    m = contract.check_grads({k: ref[0][k].cpu().numpy() for k in kbb.ROWS},
                             {k: got[0][k].cpu().numpy() for k in kbb.ROWS})
    rel = {}
    for name, a, b in [("mat", ref[1], got[1])] + [
            (k, ref[2][k], got[2][k]) for k in GEOM_PARAMS]:
        a, b = a.cpu().numpy(), b.cpu().numpy()
        scale = float(np.abs(a).max())
        rel[name] = float(np.abs(a - b).max() / max(scale, 1e-30))
        if not np.isfinite(b).all() or scale == 0.0 or not np.allclose(
                b, a, rtol=contract.GRAD_RTOL, atol=1e-4 * scale):
            raise AssertionError(f"hybrid {name} cotangent differs: max rel "
                                 f"{rel[name]}, scale {scale}")
    log(f"[hybrid] {TRAIN_LANES} lanes: d_state {json.dumps(m)}; sums "
        f"max |d| / max|ref| {json.dumps(rel)}")

    w, spp = TRAIN["width"], TRAIN["spp"]
    rays = w * w * spp

    def reset():
        torch.cuda.reset_peak_memory_stats()
        kb.LAUNCHES_FWD = kbb.LAUNCHES_BWD = ks.LAUNCHES = 0
    step, warmup_s, (loss0, *losses), walls = train_walls(
        scene, cam, {k: getattr(scene, k) for k in GEOM_PARAMS}, TRAIN, dev,
        TRAIN_STEPS, reset)
    fwd, b6, b5 = kb.LAUNCHES_FWD, ks.LAUNCHES, kbb.LAUNCHES_BWD
    peak = torch.cuda.max_memory_allocated()
    n_steps = steps_for(rays, TRAIN_ENGINE["wavefront"],
                        TRAIN_ENGINE["depth_budget"], TRAIN["max_depth"],
                        drain=TRAIN_ENGINE["drain"])
    if not fwd == b6 == n_steps * TRAIN_STEPS or b5:
        raise AssertionError(f"{fwd} B2, {b6} B6 and {b5} B5 launches for "
                             f"{TRAIN_STEPS} steps of {n_steps} bounces")
    if not all(np.isfinite([loss0] + losses)):
        raise AssertionError(f"losses {loss0} {losses}")
    sums = {}
    for k in GEOM_PARAMS:
        g = step.params[k].grad.cpu().numpy()
        sums[k] = float(np.abs(g).sum())
        if not np.isfinite(g).all() or sums[k] == 0.0:
            raise AssertionError(f"{k} gradient: finite "
                                 f"{bool(np.isfinite(g).all())}, |sum| "
                                 f"{sums[k]}")
    moved = float((step.params["sph_center0"].detach()
                   - scene.sph_center0).abs().max())
    med = sorted(walls)[len(walls) // 2]
    log(f"[geom-train] ball_scenes {w}x{w}x{spp} depth {TRAIN['max_depth']}, "
        f"params {list(GEOM_PARAMS)}, {n_steps} bounces a step: median "
        f"{rays / med:.1f} train-step rays/s (step walls {walls} s), warm-up "
        f"step {warmup_s:.3f} s, peak memory {peak} bytes, losses "
        f"{[loss0] + losses}, {fwd} B2, {b6} B6 and {b5} B5 launches, "
        f"gradient |sums| {json.dumps(sums)}, centres moved up to {moved}")
    return fwd, b6


def phase_cornell_train(dev) -> tuple[int, int, dict, dict]:
    """Phase 16: B3 and B2's external-hit mode against their plain
    versions on a cornell_boxes train state, then the cornell_boxes train
    step; returns the B3 and B2 launches of the counted step and the two
    kernels' checks at the train wavefront's shape."""
    import numpy as np

    from srt_tpu_torch import get_scene
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.kernels import spheres as ks
    from srt_tpu_torch.render.regen_scan import steps_for
    from srt_tpu_torch.scene.ir import SceneFlags

    scene, cam, _ = get_scene("cornell_boxes", device=dev)
    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=CORNELL_TRAIN["max_depth"])
    st = train_state(scene, cam, flags, tables, spec, dev,
                     size=CORNELL_TRAIN)
    walk = ki.pack_walk(scene)
    if walk["big"]:
        raise AssertionError("cornell_boxes' train step walks B4, not B3")
    b3_train = check_tri_kernel("cornell-train", scene, st["o"], st["d"])
    b2_train = check_b2("cornell-train", scene, flags, tables, st,
                                spec, ki.closest_tris(scene, walk, st["o"],
                                                      st["d"]))

    w, spp = CORNELL_TRAIN["width"], CORNELL_TRAIN["spp"]

    def reset():
        ki.LAUNCHES = ki.LAUNCHES_BIG = kb.LAUNCHES_FWD = 0
        ks.LAUNCHES = kbb.LAUNCHES_BWD = 0
    step, _, (loss0, loss), (wall,) = train_walls(
        scene, cam, {"tex_color": scene.tex_color}, CORNELL_TRAIN, dev, 1,
        reset)
    b3, b2, b6, b5, b4 = (ki.LAUNCHES, kb.LAUNCHES_FWD, ks.LAUNCHES,
                          kbb.LAUNCHES_BWD, ki.LAUNCHES_BIG)
    n_steps = steps_for(w * w * spp, TRAIN_ENGINE["wavefront"],
                        TRAIN_ENGINE["depth_budget"],
                        CORNELL_TRAIN["max_depth"],
                        drain=TRAIN_ENGINE["drain"])
    if not b3 == b2 == n_steps or b6 or b5 or b4:
        raise AssertionError(f"{b3} B3, {b2} B2, {b6} B6, {b5} B5, {b4} B4 "
                             f"launches for {n_steps} bounces")
    g = step.params["tex_color"].grad.cpu().numpy()
    if not np.isfinite([loss0, loss]).all() or not np.isfinite(g).all() \
            or not np.abs(g).sum() > 0.0:
        raise AssertionError(f"cornell train: losses {loss0} {loss}, "
                             f"gradient {g}")
    log(f"[cornell-train] cornell_boxes {w}x{w}x{spp} depth "
        f"{CORNELL_TRAIN['max_depth']}, params ['tex_color'], {n_steps} "
        f"bounces a step: step wall {wall:.3f} s ({w * w * spp / wall:.1f} train-step "
        f"rays/s), losses {[loss0, loss]}, {b3} B3, {b2} B2, {b6} B6, {b5} "
        f"B5 launches, tex_color gradient finite, |sum| "
        f"{float(np.abs(g).sum())}")
    return b3, b2, b3_train, b2_train


def media_room(dev):
    """Phase 17's media scene: ``tests/_torch_scenes.py:lit_room_media``
    (a sphere and a box medium, metal, glass and image-albedo spheres, two
    rect lights) built with the port's builder, and its camera."""
    from _torch_scenes import LIT_ROOM_CAMERA, lit_room_media

    from srt_tpu_torch.render.camera import Camera
    from srt_tpu_torch.scene.build import SceneBuilder

    return (lit_room_media(SceneBuilder()).build(dev),
            Camera.look_at(**LIT_ROOM_CAMERA, device=dev))


def rich_scene(name: str, dev):
    """A scene of phases 17, 19 and 20 and its camera: the media room, or
    a library scene (its absent assets' stand-ins without a warning)."""
    import warnings

    from srt_tpu_torch import get_scene

    if name == "lit_room_media":
        return media_room(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene(name, device=dev)
    return scene, cam


# the families phase 17's step must shade on each scene
RICH_EXPECT = {"random_scene": ("checker", "specular"),
               "final1": ("diffuse",),
               "two_perlin_spheres": ("marble", "sphere_light_sample"),
               "earth_sphere": ("image", "sphere_light_sample"),
               "lit_room_media": ("medium", "specular", "image")}


def phase_rich_kernel(dev) -> dict:
    """Phase 17: B1's rich instantiation against its plain version on a
    mid-flight 65,536-lane step of each of ``RICH_CASES``; returns the
    largest error and the cases' times and bounds."""
    import numpy as np
    import torch
    from _torch_census import bounce_census

    from srt_tpu_torch.core.sobol import sobol_points
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    spec = kb.RegenSpec(width=512, height=512, spp=16, max_depth=50,
                        rr_start=1 << 30, pdf_floor=1e-9, seed=0)
    jitter = torch.from_numpy(sobol_points(16, 2).astype(np.float32))
    out = {"max_abs_err": 0.0, "cases": {}}
    for name, row in RICH_CASES:
        scene, cam = rich_scene(name, dev)
        flags = SceneFlags.of(scene)
        inp = kb.RegenInputs(scene, flags, cam, jitter)
        # final1 (Lambertian spheres, a rect light) is lean: it is here for
        # its 1,000 spheres, 48 KB of records in shared memory
        if inp.rich != (name != "final1"):
            raise AssertionError(f"{name} takes B1's "
                                 f"{'rich' if inp.rich else 'lean'} "
                                 "instantiation")
        mid = b1_wavefront(inp, spec, dev, row * spec.width * spec.spp)
        rows = {k: mid[k].T for k in ("o", "d", "beta", "radiance")}
        state, take, _ = kb.regenerate(inp, spec, dict(
            mid, **rows, alive=mid["alive"] != 0), mid["cursor"])
        c = bounce_census(scene, state["o"], state["d"], state["time"],
                   state["salt"], state["depth"], state["alive"])
        st_k, st_p = clone(mid), clone(mid)
        launches = kb.LAUNCHES
        kb.regen_bounce(inp, st_k, spec)
        kb.regen_bounce_reference(inp, st_p, spec)
        torch.cuda.synchronize()
        if kb.LAUNCHES != launches + 1:
            raise AssertionError(f"B1 {name}: the kernel did not launch")
        for k in ("salt", "pix", "depth", "cursor"):
            if not torch.equal(st_k[k], st_p[k]):
                bad = int((st_k[k] != st_p[k]).sum())
                raise AssertionError(f"B1 {name}: {k} differs on {bad} lanes")
        fin_mismatch = float((st_k["fin"] != st_p["fin"]).float().mean())
        if fin_mismatch > contract.ALIVE_MISMATCH:
            raise AssertionError(f"B1 {name}: fin mismatch {fin_mismatch}")
        m = contract.check_bounce(contract.wavefront_arrays(st_p),
                                  contract.wavefront_arrays(st_k))
        missing = [f for f in RICH_EXPECT[name] if not c[f]]
        if missing:
            raise AssertionError(f"B1 {name}: the step shades no {missing}: "
                                 f"{c}")
        kern_ms = [b1_launch_ms(inp, mid, spec, 50) for _ in range(2)]
        plain_ms = time_bounces(kb.regen_bounce_reference, inp, mid, spec, 3)
        n_new = int(take.sum())
        ms_bound, by = bound(LANES * (68 + 12) + c["live"] * 48 + n_new * 12,
                             shade_ops(scene, flags, c))
        err = max(m[k]["max"] for k in ("d", "beta", "radiance"))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["cases"][name] = dict(ms=min(kern_ms), plain_ms=plain_ms,
                                  bound_ms=ms_bound, bound_by=by)
        log(f"[rich-{name}] {'rich' if inp.rich else 'lean'} B1, {LANES} "
            f"lanes, {scene.n_spheres} spheres, "
            f"{scene.n_rects} rects, {scene.n_media} media, lights "
            f"{list(flags.light_kinds)}: ints exact, fin mismatch "
            f"{fin_mismatch}, {json.dumps(m)}; shaded {json.dumps(c)} "
            f"({n_new} regenerated); ms per launch {kern_ms}, plain "
            f"{plain_ms:.3f}, bound {ms_bound:.6f} ({by})")
    return out


def phase_final_ext(dev) -> dict:
    """Phase 18, first part: B2's external-hit mode with marble and image
    albedo on a mid-flight ``final`` wavefront against its plain version,
    the triangles walked by B3."""
    import warnings

    from srt_tpu_torch import get_scene
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.scene.ir import SceneFlags

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene("final", device=dev)
    st, inp, step, _ = tri_wavefront(scene, cam, dev, row=FINAL_ROW)
    walk = ki.pack_walk(scene)
    if walk["big"]:
        raise AssertionError("final's triangles take B4, not B3")
    tri = ki.closest_tris(scene, walk, st["o"], st["d"])
    out = check_b2("final", scene, SceneFlags.of(scene), inp.tables,
                           st, step, tri)
    for k in ("marble", "image", "medium", "specular"):
        if not out["census"][k]:
            raise AssertionError(f"B2 final: no {k} lane: {out['census']}")
    return out


def phase_rich_render(dev) -> int:
    """Phase 18, second part: the new path, random_scene through B1's
    rich instantiation; returns its launches in the timed renders."""
    import warnings

    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, get_scene, render_regen
    from srt_tpu_torch.kernels import bounce as kb

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene("random_scene", device=dev)
    cfg = RenderConfig(**MAIN)
    t0 = time.time()
    render_regen(scene, cam, cfg)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    kb.LAUNCHES = 0
    runs = []
    for _ in range(TRI_MAIN_REPS):
        img, met = render_regen(scene, cam, cfg, metrics=True)
        runs.append((img.cpu().numpy(), met))
    launches = kb.LAUNCHES
    bounces = sum(m.bounces for _, m in runs)
    if launches != bounces or launches == 0:
        raise AssertionError(f"random_scene: {launches} B1 launches for "
                             f"{bounces} bounces")
    for img, met in runs:
        nan_pixels = int(np.isnan(img).sum())
        mean = float(img.mean())
        if (not np.isfinite(img).all() or nan_pixels
                or not RICH_MEAN[0] < mean < RICH_MEAN[1]):
            raise AssertionError(f"random_scene image: mean {mean}, nan "
                                 f"{nan_pixels}")
    rates = sorted(m.primary_rays_per_sec for _, m in runs)
    log(f"[rich-main] random_scene {MAIN['width']}x{MAIN['height']}x"
        f"{MAIN['spp']} depth {MAIN['max_depth']}, {TRI_MAIN_REPS} renders: "
        f"median {rates[len(rates) // 2]:.1f} primary rays/s (all {rates}), "
        f"first render {warmup_s:.3f}s, mean {mean:.5f}, nan_pixels "
        f"{nan_pixels}, {launches} B1 launches for {bounces} bounces, "
        f"{json.dumps(met.to_dict())}")
    return launches


def phase_rich_bwd(dev) -> dict:
    """Phase 19: B2's and B5's rich instantiations against their plain
    versions on a train state of each scene of ``RICH_BWD_EXPECT``, the
    forward and the backward of every bounce of phase 20's steps; returns
    each kernel's largest error and the cases' times and bounds."""
    import numpy as np
    import torch
    from _torch_census import bounce_census

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.kernels import build
    from srt_tpu_torch.kernels.build import launch
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    regs = kernel_registers(build.ptxas_report(), "bounce_bwd_kernel")
    log(f"[rich-bwd] ptxas registers of B5 (lean 0, rich 1): "
        f"{json.dumps(regs)}")
    spec = kb.StepSpec(max_depth=TRAIN["max_depth"])
    n = TRAIN_LANES
    out = {"max_abs_err": 0.0, "cases": {}, "b2_err": 0.0, "b2_cases": {}}
    for name, expect in RICH_BWD_EXPECT.items():
        scene, cam = rich_scene(name, dev)
        flags = SceneFlags.of(scene)
        tables = kb.build_tables(scene, flags)
        st = train_state(scene, cam, flags, tables, spec, dev)
        if not kb.fwd_args(scene, flags, tables, st, spec)[0].rich:
            raise AssertionError(f"B2 {name}: not the rich instantiation")
        b2 = check_b2(f"rich-train-{name}", scene, flags, tables, st, spec)
        out["b2_err"] = max(out["b2_err"], b2["max_abs_err"])
        out["b2_cases"][name] = {k: b2[k] for k in ("ms", "plain_ms",
                                                    "bound_ms", "bound_by")}
        c = bounce_census(scene, st["o"], st["d"], st["time"], st["salt"],
                          st["depth"], st["alive"])
        missing = [f for f in expect if not c[f]]
        if missing:
            raise AssertionError(f"B5 {name}: the state holds no {missing}: "
                                 f"{c}")
        with torch.no_grad():
            ends = ~kb.bounce_step_ref(scene, flags, tables["mat"], st,
                                       spec)["alive"]
        r = np.random.default_rng(5)
        ct = {k: torch.from_numpy(r.standard_normal((n, 3))
                                  .astype(np.float32)).to(dev)
              for k in kbb.ROWS}
        for k in ("o", "d", "beta"):
            ct[k][ends] = 0.0
        rich0 = kbb.LAUNCHES_BWD_RICH
        g_k, dmat_k = kbb.bounce_bwd(scene, flags, tables, st, ct, spec)
        g_p, dmat_p = kbb.bounce_bwd_reference(scene, flags, tables["mat"],
                                               st, ct, spec)
        torch.cuda.synchronize()
        if kbb.LAUNCHES_BWD_RICH != rich0 + 1:
            raise AssertionError(f"B5 {name}: the rich kernel did not launch")
        m = contract.check_grads({k: g_p[k].cpu().numpy() for k in kbb.ROWS},
                                 {k: g_k[k].cpu().numpy() for k in kbb.ROWS})
        a, b = dmat_p.cpu().numpy(), dmat_k.cpu().numpy()
        scale = float(np.abs(a).max())
        mat_rel = float(np.abs(a - b).max() / max(scale, 1e-30))
        if not np.isfinite(b).all() or scale == 0.0 or not np.allclose(
                b, a, rtol=contract.GRAD_RTOL, atol=1e-4 * scale):
            raise AssertionError(f"B5 {name}: material sums differ: max rel "
                                 f"{mat_rel}, scale {scale}")
        bargs, _ = kbb.bwd_args(scene, flags, tables, st, ct, spec)
        kern_ms = [time_ms(lambda: launch("srt_bounce_bwd", bargs, dev), 200)
                   for _ in range(2)]
        plain_ms = time_ms(lambda: kbb.bounce_bwd_reference(
            scene, flags, tables["mat"], st, ct, spec), 3)
        # each lane reads 105 B (state, salt, depth, alive, cotangents) and
        # writes 92 B (cotangents, ten material columns, the id); the
        # sweeps run once, the shading's VJP VJP_SHADE times its forward
        sweeps = c["live"] * (scene.n_spheres * OPS_SPHERE
                              + scene.n_rects * OPS_RECT
                              + scene.n_media * OPS_MEDIUM)
        ops = sweeps + VJP_SHADE * (shade_ops(scene, flags, c) - sweeps)
        ms_bound, by = bound(n * (105 + 92), ops)
        out["max_abs_err"] = max(out["max_abs_err"], m["max_abs"])
        out["cases"][name] = dict(ms=min(kern_ms), plain_ms=plain_ms,
                                  bound_ms=ms_bound, bound_by=by)
        log(f"[rich-bwd-{name}] {n} lanes, {int(st['alive'].sum())} live: "
            f"d_state {json.dumps(m)}, (M,14) sums max |d| / max|ref| "
            f"{mat_rel:.3e}; families {json.dumps(c)}; ms per launch "
            f"{kern_ms}, plain {plain_ms:.3f}, bound {ms_bound:.6f} ({by})")
    return out


def phase_rich_train(dev) -> dict:
    """Phase 20: the train step on the rich families, then the hybrid
    step on random_scene after B2 and B6 are held against their plain
    versions on its train state; returns the B2, B5 and B6 launches of the
    timed steps and those two checks."""
    import numpy as np
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.kernels import spheres as ks
    from srt_tpu_torch.render.regen_scan import steps_for
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.trainbench import phase_walls

    def counts():
        return (kb.LAUNCHES_FWD, kbb.LAUNCHES_BWD, kbb.LAUNCHES_BWD_RICH,
                ks.LAUNCHES)

    def reset():
        kb.LAUNCHES_FWD = kbb.LAUNCHES_BWD = kbb.LAUNCHES_BWD_RICH = 0
        ks.LAUNCHES = 0

    def grads_of(step) -> dict:
        gs = {k: v.grad.cpu().numpy() for k, v in step.params.items()}
        nan = sum(int(np.isnan(g).sum()) for g in gs.values())
        if nan or not all(np.isfinite(g).all() for g in gs.values()):
            raise AssertionError(f"gradients with {nan} NaN: {gs}")
        return {k: float(np.abs(g).sum()) for k, g in gs.items()}

    w, spp = TRAIN["width"], TRAIN["spp"]
    rays = w * w * spp
    n_steps = steps_for(rays, TRAIN_ENGINE["wavefront"],
                        TRAIN_ENGINE["depth_budget"], TRAIN["max_depth"],
                        drain=TRAIN_ENGINE["drain"])
    total = {"b2": 0, "b5": 0, "b6": 0}
    for name in RICH_BWD_EXPECT:
        scene, cam = rich_scene(name, dev)
        params = {"tex_color": scene.tex_color}
        if name == "lit_room_media":
            params["mat_params"] = scene.mat_params
        step, warmup_s, (loss0, *losses), walls = train_walls(
            scene, cam, params, TRAIN, dev, TRAIN_STEPS, reset)
        fwd, bwd, rich, b6 = counts()
        want = n_steps * TRAIN_STEPS
        if not fwd == bwd == rich == want or b6:
            raise AssertionError(f"{name}: {fwd} B2, {bwd} B5 ({rich} rich) "
                                 f"and {b6} B6 launches for {TRAIN_STEPS} "
                                 f"steps of {n_steps} bounces")
        total["b2"] += fwd
        total["b5"] += bwd
        if not np.isfinite([loss0] + losses).all():
            raise AssertionError(f"{name}: losses {loss0} {losses}")
        sums = grads_of(step)
        walls_split = phase_walls(
            step, torch.full((w, w, 3), TRAIN_TARGET, device=dev),
            TRAIN_STEPS + 1)
        med = sorted(walls)[len(walls) // 2]
        log(f"[rich-train-{name}] {w}x{w}x{spp} depth {TRAIN['max_depth']}, "
            f"params {sorted(params)}, {n_steps} bounces a step: median "
            f"{rays / med:.1f} train-step rays/s (step walls {walls} s), "
            f"warm-up step {warmup_s:.3f} s, split {json.dumps(walls_split)}, "
            f"losses {[loss0] + losses}, {fwd} B2 and {bwd} B5 launches "
            f"({rich} rich), 0 B6, gradients finite, 0 NaN, |sums| "
            f"{json.dumps(sums)}")

    # the kernels of the hybrid step, first on a 16,384-lane random_scene
    # train state: B2's rich kMoving instantiation (the forward) and B6
    # on its 484 moving spheres (the backward's winner)
    scene, cam = rich_scene("random_scene", dev)
    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=HYBRID_RICH["max_depth"])
    st = train_state(scene, cam, flags, tables, spec, dev)
    if not (flags.moving and kb.fwd_args(scene, flags, tables, st,
                                         spec)[0].rich):
        raise AssertionError("B2 random_scene: not the rich kMoving "
                             "instantiation")
    total["b2_moving"] = check_b2("rich-moving-random_scene", scene, flags,
                                  tables, st, spec)
    total["b6_check"] = check_winner("random_scene", scene, st["o"], st["d"],
                                     st["time"])
    hw, hspp = HYBRID_RICH["width"], HYBRID_RICH["spp"]
    h_steps = steps_for(hw * hw * hspp, TRAIN_ENGINE["wavefront"],
                        TRAIN_ENGINE["depth_budget"], HYBRID_RICH["max_depth"],
                        drain=TRAIN_ENGINE["drain"])
    step, _, (loss0, loss), (wall,) = train_walls(
        scene, cam, {"tex_color": scene.tex_color}, HYBRID_RICH, dev, 1,
        reset)
    fwd, bwd, rich, b6 = counts()
    if not fwd == b6 == h_steps or bwd:
        raise AssertionError(f"random_scene: {fwd} B2, {b6} B6 and {bwd} B5 "
                             f"launches for {h_steps} bounces")
    if not np.isfinite([loss0, loss]).all():
        raise AssertionError(f"random_scene: losses {loss0} {loss}")
    total["b2"] += fwd
    total["b6"] += b6
    sums = grads_of(step)
    log(f"[rich-train-random_scene] hybrid, {hw}x{hw}x{hspp} depth "
        f"{HYBRID_RICH['max_depth']} (width cut from {w}: the torch replay), "
        f"params ['tex_color'], {h_steps} bounces: step wall {wall:.3f} s "
        f"({hw * hw * hspp / wall:.1f} train-step rays/s), losses "
        f"{[loss0, loss]}, {fwd} B2, {b6} B6, {bwd} B5 launches, gradient "
        f"finite, 0 NaN, |sum| {json.dumps(sums)}")
    return total


def cornell_times(dev) -> dict:
    """``--measure`` on cornell_boxes: B3 and B2's external hit as bare
    launches on phase 7's render wavefront, ``COMPARE_ROUNDS`` times, and two
    steps of phase 16's train cell."""
    import ctypes

    from srt_tpu_torch import get_scene
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.scene.ir import SceneFlags

    scene, cam, _ = get_scene("cornell_boxes", device=dev)
    flags = SceneFlags.of(scene)
    st, inp, step, _ = tri_wavefront(scene, cam, dev)
    packed = ki.pack_tables(scene)
    tri = ki.intersect_tris(scene, packed, st["o"], st["d"])
    out = {"b3_ms": [], "b2_ext_ms": []}
    for _ in range(COMPARE_ROUNDS):
        out["b3_ms"].append(bare_launch_ms(
            "srt_intersect_tris", ctypes.sizeof(ki._Args),
            lambda: ki.intersect_tris(scene, packed, st["o"], st["d"]), 200))
        out["b2_ext_ms"].append(bare_launch_ms(
            "srt_bounce", ctypes.sizeof(kb._BounceArgs),
            lambda: kb.bounce_fwd(scene, flags, inp.tables, st, step, tri),
            200))
    out["train_s"] = train_walls(scene, cam, {"tex_color": scene.tex_color},
                                 CORNELL_TRAIN, dev, 2)[3]
    return out


def b5_bare_times(scene, cam, dev) -> list:
    """``--measure``: the lean B5 as bare launches on phase 5's ball_scenes
    train state, ``COMPARE_ROUNDS`` times, 200 launches each."""
    import ctypes

    import numpy as np
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.scene.ir import SceneFlags

    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=TRAIN["max_depth"])
    st = train_state(scene, cam, flags, tables, spec, dev)
    r = np.random.default_rng(2)
    ct = {k: torch.from_numpy(r.standard_normal((TRAIN_LANES, 3))
                              .astype(np.float32)).to(dev) for k in kbb.ROWS}
    return [bare_launch_ms("srt_bounce_bwd", ctypes.sizeof(kbb._BwdArgs),
                           lambda: kbb.bounce_bwd(scene, flags, tables, st,
                                                  ct, spec), 200)
            for _ in range(COMPARE_ROUNDS)]


def measure_tree() -> dict:
    """``--measure``: what ``--compare`` times in one checkout, with the
    package found first on ``sys.path``: its build, ``ptxas``' registers
    of B1, B2 and B5, B1 on phase 3's ball_scenes wavefront as bare
    launches and through its wrapper (``COMPARE_ROUNDS`` times, 50
    launches each), the lean B5 as bare launches (``b5_bare_times``), the
    ball_scenes train step with ``{"tex_color"}`` (phase 6, three steps)
    and with the geometric parameters (phase 15, two steps), and
    ``cornell_times``. A measurement the checkout's package cannot make
    holds its error instead."""
    import numpy as np
    import torch

    from srt_tpu_torch import get_scene
    from srt_tpu_torch.core.sobol import sobol_points
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import build
    from srt_tpu_torch.scene.ir import SceneFlags

    dev = torch.device("cuda", 0)
    t0 = time.time()
    build.load_library()
    out = {"build_s": time.time() - t0}
    report = build.ptxas_report()
    out["registers"] = {k: kernel_registers(report, k) for k in
                        ("regen_bounce_kernel", "bounce_kernel",
                         "bounce_bwd_kernel")}
    scene, cam, _ = get_scene("ball_scenes", device=dev)
    spec = kb.RegenSpec(width=512, height=512, spp=16, max_depth=50,
                        rr_start=1 << 30, pdf_floor=1e-9, seed=0)
    inp = kb.RegenInputs(scene, SceneFlags.of(scene), cam, torch.from_numpy(
        sobol_points(16, 2).astype(np.float32)))
    mid = b1_wavefront(inp, spec, dev, spec.total_work // 2)
    out["b1_bare_ms"] = [b1_launch_ms(inp, mid, spec, 50)
                         for _ in range(COMPARE_ROUNDS)]
    out["b1_wrapped_ms"] = [time_bounces(kb.regen_bounce, inp, mid, spec, 50)
                            for _ in range(COMPARE_ROUNDS)]
    for key, fn in (
            ("b5_bare_ms", lambda: b5_bare_times(scene, cam, dev)),
            ("train_s", lambda: train_walls(
                scene, cam, {"tex_color": scene.tex_color}, TRAIN, dev,
                TRAIN_STEPS)[3]),
            ("geom_train_s", lambda: train_walls(
                scene, cam, {k: getattr(scene, k) for k in GEOM_PARAMS},
                TRAIN, dev, 2)[3]),
            ("cornell", lambda: cornell_times(dev))):
        try:
            out[key] = fn()
        except Exception as e:      # a path this checkout does not have
            out[key] = f"{type(e).__name__}: {e}"[:300]
    return out


def compare(trees: list) -> None:
    """``--compare``: each checkout in ``trees`` in turns, in the order
    given and then in reverse (A B C C B A), each time in fresh processes
    that import that checkout's package and build its kernels from its own
    sources: ``measure_tree`` with this script's timers, then
    ``python -m srt_tpu_torch.bench`` (ball_scenes 512x512x16x50) from the
    checkout. Prints a line per run and each checkout's extremes."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[compare] {smi}")
    runs = {t: [] for t in trees}
    for tree in trees + trees[::-1]:
        path = os.path.abspath(tree)
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure"],
            cwd=path, capture_output=True, text=True)
        lines = [ln for ln in child.stdout.splitlines()
                 if ln.startswith("compare ")]
        if child.returncode or not lines:
            raise SystemExit(f"--measure in {tree} failed:\n{child.stdout}\n"
                             f"{child.stderr[-4000:]}")
        res = json.loads(lines[-1][len("compare "):])
        bench = subprocess.run([sys.executable, "-m", "srt_tpu_torch.bench",
                                "--min-seconds", "3"], cwd=path,
                               capture_output=True, text=True)
        if bench.returncode:
            raise SystemExit(f"bench in {tree} failed:\n"
                             f"{bench.stderr[-4000:]}")
        res["bench_rays_per_s"] = json.loads(
            bench.stdout.strip().splitlines()[-1])["value"]
        log(f"[compare] {tree} {json.dumps(res)}")
        runs[tree].append(res)

    def extremes(rs, *keys):
        """The least and the largest value under ``keys`` in the runs
        ``rs``; null where no run measured it."""
        vals = []
        for r in rs:
            for k in keys:
                r = r.get(k) if isinstance(r, dict) else None
            vals += (r if isinstance(r, list)
                     else [r] if isinstance(r, (int, float)) else [])
        return [min(vals), max(vals)] if vals else None
    log("[compare] summary " + json.dumps({t: {
        "b1_bare_ms": extremes(rs, "b1_bare_ms"),
        "b1_wrapped_ms": extremes(rs, "b1_wrapped_ms"),
        "b5_bare_ms": extremes(rs, "b5_bare_ms"),
        "bench_rays_per_s": extremes(rs, "bench_rays_per_s"),
        "train_s": extremes(rs, "train_s"),
        "geom_train_s": extremes(rs, "geom_train_s"),
        "cornell_train_s": extremes(rs, "cornell", "train_s"),
        "cornell_b3_ms": extremes(rs, "cornell", "b3_ms"),
        "cornell_b2_ext_ms": extremes(rs, "cornell", "b2_ext_ms"),
        "registers": rs[0]["registers"]} for t, rs in runs.items()}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ppm", default=None,
                    help="also write the main-path image (sqrt gamma) here")
    ap.add_argument("--compare", nargs="+", metavar="TREE",
                    help="instead of the smoke run, time B1, B5, B2, B3, the "
                    "ball_scenes render and the train steps of each "
                    "checkout in turns")
    ap.add_argument("--measure", action="store_true",
                    help=argparse.SUPPRESS)   # one run of --compare
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if args.compare:
        compare(args.compare)
        return
    if args.measure:    # the checkout in the working directory
        sys.path.insert(0, os.getcwd())
        print("compare " + json.dumps(measure_tree()), flush=True)
        return
    root = os.path.dirname(os.path.abspath(__file__))
    # the package, and the tests' helpers: the media room (_torch_scenes)
    # and the bounce census (_torch_census)
    sys.path[:0] = [root, os.path.join(root, "tests")]

    from srt_tpu_torch import get_scene
    from srt_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # --- 2. build -------------------------------------------------------
    t0 = time.time()
    build.load_library()
    log(f"[build] {time.time() - t0:.1f}s {build.library_path()}")
    for line in build.ptxas_report().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    scene, cam, _ = get_scene("ball_scenes", device=dev)
    b1 = phase_regen_kernel(scene, cam, dev)                  # 3
    b1["launches"] = phase_render(scene, cam, args.ppm)       # 4
    b2, b5 = phase_train_kernels(scene, cam, dev)             # 5
    b2_train, b5["launches"] = phase_train(scene, cam, dev)   # 6
    tri_scene, tri_cam, _ = get_scene("cornell_boxes", device=dev)
    b3, b2_ext = phase_tri_kernels(tri_scene, tri_cam, dev)   # 7, 8
    b3["launches"], b2_render = phase_tri_render(tri_scene, tri_cam)   # 9
    del tri_scene
    pot, pot_cam = teapot(dev)
    b4, b2_pot = phase_teapot_kernels(pot, pot_cam, dev)      # 10, 11
    b4["launches"], b2_pot_render = phase_teapot_render(pot, pot_cam)  # 12
    del pot
    b6 = phase_winner(scene, cam, dev)                        # 13
    phase_moving_bounces(scene, cam, dev)                     # 14
    b2_geom, b6["launches"] = phase_geom_train(scene, cam, dev)   # 15
    b3_train, b2_cornell, b3_ct, b2_ct = phase_cornell_train(dev)   # 16
    rich = phase_rich_kernel(dev)                             # 17
    b2_final = phase_final_ext(dev)                           # 18
    b1_rich = phase_rich_render(dev)
    rich_bwd = phase_rich_bwd(dev)                            # 19
    rich_train = phase_rich_train(dev)                        # 20
    log(f"[kernels] B5 launches: {b5['launches']} lean on the ball_scenes "
        f"train path, {rich_train['b5']} rich on the rich train paths; B5 "
        f"ms per launch {b5['ms']} (lean, ball_scenes), rich "
        f"{json.dumps(rich_bwd['cases'])}; B2 {rich_train['b2']} and B6 "
        f"{rich_train['b6']} launches on the rich train paths; B2 ms per "
        f"launch on the rich train states {json.dumps(rich_bwd['b2_cases'])}"
        f", on random_scene's (kMoving) {rich_train['b2_moving']['ms']}; B6 "
        f"on random_scene's {rich_train['b6_check']['ms']}")
    b5["launches"] += rich_train["b5"]
    b6["launches"] += rich_train["b6"]
    b5["max_abs_err"] = max(b5["max_abs_err"], rich_bwd["max_abs_err"])
    b6["max_abs_err"] = max(b6["max_abs_err"],
                            rich_train["b6_check"]["max_abs_err"])
    b1["max_abs_err"] = max(b1["max_abs_err"], rich["max_abs_err"])
    log(f"[kernels] B1 launches: {b1['launches']} on the ball_scenes render "
        f"path, {b1_rich} on the random_scene render path; B1 ms per launch "
        f"{b1['ms']} (ball_scenes, lean), rich "
        f"{json.dumps(rich['cases'])}; B2 on final {b2_final['ms']} ms "
        f"(plain {b2_final['plain_ms']}, bound {b2_final['bound_ms']})")
    b1["launches"] += b1_rich
    b3["launches"] += b3_train
    b3["max_abs_err"] = max(b3["max_abs_err"], b3_ct["max_abs_err"])
    b2["launches"] = (b2_train + b2_render + b2_pot_render + b2_geom
                      + b2_cornell + rich_train["b2"])
    b2["max_abs_err"] = max(b2["max_abs_err"], b2_ext["max_abs_err"],
                            b2_pot["max_abs_err"], b2_ct["max_abs_err"],
                            b2_final["max_abs_err"], rich_bwd["b2_err"],
                            rich_train["b2_moving"]["max_abs_err"])
    log(f"[kernels] B2 launches: {b2_train} on the train path, {b2_render} "
        f"in external-hit mode on the cornell render path, {b2_pot_render} "
        f"on the teapot render path, {b2_geom} on the geometry train path, "
        f"{b2_cornell} on the cornell train path; B3 launches "
        f"{b3['launches'] - b3_train} on the cornell render path and "
        f"{b3_train} on the cornell train path; B2 ms per launch "
        f"{b2['ms']} (train state, 16,384 lanes), {b2_ext['ms']} (cornell external hit, "
        f"65,536 lanes), {b2_ct['ms']} (cornell train state, external hit, "
        f"16,384 lanes; plain {b2_ct['plain_ms']}, bound "
        f"{b2_ct['bound_ms']}), {b2_pot['ms']} (teapot: specular and media, "
        f"65,536 lanes); B3 ms per launch {b3['ms']} (cornell render "
        f"wavefront, 65,536 lanes), {b3_ct['ms']} (cornell train state, "
        f"16,384 lanes; plain {b3_ct['plain_ms']}, bound "
        f"{b3_ct['bound_ms']}); B4 {b4['ms']} ms against B3 {b4['b3_ms']} "
        f"ms on the teapot's wavefront after three bounces")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in (b1, b2, b3, b4, b5, b6)]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
