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
   wrapper); the same step at every G (threads a lane for the sphere
   sweep, ``kernels/bounce.py:SHARES``), each equal to the bit to the
   host's G, with its time; ``ptxas``' registers and spill stores of B1's
   instantiations, lean and rich, static and moving, at each G, and of
   B2's (with and without the external hit, with and without parity);
4. the render path: ``render_regen`` on ball_scenes at 512x512, 16 spp,
   depth 50, a 65,536-lane wavefront and seed 0, through B1 and the film
   kernel (one launch each a bounce), once to warm up and five times
   timed;
5. the train kernels against their plain versions on the card, on a
   16,384-lane ball_scenes state (``render_pixels``' camera rays, three
   plain bounces, a seeded half of the lanes dead): one launch of the
   forward kernel (B2) against the plain step (and at every G, equal to
   the bit), one launch of the backward kernel (B5) against
   ``torch.autograd`` of the plain step, and the time per bounce of each;
   B5's width K, its passes P and ``ptxas``' registers and spill stores;
6. the train path: ``make_train_step`` on ball_scenes at 256x256, 4 spp,
   depth 50, a 16,384-lane wavefront, depth budget 4.0, drain 12,
   parameters ``{"tex_color"}``, Adam at 1e-2, a constant 0.3 target: one
   step to warm up, then three timed steps with seeds 1-3, 76 bounces
   each, every bounce one B2, one B5 and one material-sum launch;
7. the triangle BVH kernel (B3) against its plain version on two inputs:
   a mid-flight 65,536-lane cornell_boxes wavefront, and the 4,800
   triangles of ``final``'s ground field (its 400 boxes and their seeded
   heights) under ``final``'s camera rays: hit and index equality, |dt|
   within 2e-5 and |du|, |dv| within 1e-4 on the hits, the time per
   launch and the bound;
   B3 at every G (threads a ray for its walk,
   ``kernels/intersect.py:WALK_SHARES``), each equal to the bit to the
   host's G, with its time; ``ptxas``' registers and spill stores of B3
   and B6 at each G (again in phases 13 and 16);
8. B2's external-hit mode against its plain version on input (a) (every
   B2 check, here and in phases 11, 16, 18, 19, 20 and 21, also launches
   B2 at every G, each equal to the bit to the host's G, with its time);
9. the triangle render path: ``render_regen`` on cornell_boxes at 512x512,
   16 spp, depth 50, a 65,536-lane wavefront and seed 0, first kernels
   against plain versions on a 64x64, 4 spp, depth 8 image, then once to
   warm up and three times timed, every bounce one B3, one B2 and one film
   launch;
10. the two-level BVH kernel (B4) against its plain version on
   ``teapot_scene`` at divs=100 (1,278,400 triangles; the seconds of the
   host build's tessellation, BVH, clusters and upload as the builder
   records them), on two inputs: the camera rays of a 65,536-lane
   wavefront at rows 448-455 (the teapots and the glass sphere) and the
   same wavefront after three plain bounces: hit and index equality, |dt|
   within 2e-5 and |du|, |dv| within 1e-4 on the hits, B4 against B3 on
   the same rays, the time per launch of B4 (and at 128, 256 and 512
   threads a block, each equal to the bit), B3 and the plain walk beside
   the longest walk's visits, B4's registers, and the bound from the
   records the plain walk read; the kernels line takes B4's numbers from
   the bounced input;
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
   index equal and ``t`` equal to the bit; B6 at every G of
   ``kernels/bounce.py:SHARES``, each equal to the bit to the host's G;
   the time per launch (at each G) and the bound;
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
   depth 50 on phase 6's engine: first B3 against its plain walk and at
   every G (as in phase 7) and B2's external-hit mode against its plain version (as in
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
   launch and the bound, and each step at every G as in phase 3;
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
   registers, spill stores, K and P of the rich B5;
20. the train step on the rich families at phase 6's settings: each of
   those four scenes through ``make_train_step`` (``{"tex_color"}``, the
   media room ``{"mat_params", "tex_color"}``), one step to warm up, three
   timed and one split into forward, backward and Adam, every bounce one
   B2 and one rich B5 launch and no B6; then, on a 16,384-lane
   ``random_scene`` train state, B2's rich ``kMoving`` instantiation
   against the plain step and B6 against its plain version on its 484
   moving spheres (as in phase 13, at every G), and the hybrid on
   ``random_scene`` (moving spheres) with ``{"tex_color"}`` at 64x64, 4
   spp, depth 50, one step (the width cut because the hybrid's torch
   replay takes about 0.1 s a bounce), every bounce one B2 and one B6
   launch and no B5; the losses and gradients finite, no NaN;
21. B2's parity instantiation (``kParity``) against the plain step under
   the per-bounce contract and the ``stale`` plane's, on three mid-flight
   65,536-lane wavefronts of the parity render path (phase 7's, three
   plain bounces in): ball_scenes, ball_scenes with ``parity_no_stale``,
   and cornell_boxes with B3's hit as the external hit; the parity census
   (lanes that drew and retried, heap-slot reads of 0 and 1e30, stores),
   which must reach each mechanism; the time per bare launch and the
   bound; ``ptxas``' registers and spill stores of every B2 and B1
   instantiation;
22. the parity render path: ``render_regen`` with ``ref_parity`` on
   ball_scenes, first kernel against plain on a 64x64, 4 spp, depth 8
   image, then at 512x512, 16 spp, depth 50, a 65,536-lane wavefront and
   seed 0 once to warm up and three times timed, every bounce one B2
   parity launch and no B1; then cornell_boxes at the same settings, one
   counted render, every bounce one B3 and one B2 parity launch; no NaN;
23. the golden tool (``python -m srt_tpu_torch.golden``, called in
   process): cornell_boxes at 512x512 and 64 spp with and without parity
   against ``goldens/cornell_boxes_512.png``, the parity image darker on
   the golden's tonemapped scale (diffuse surfaces lit by NEE only), and
   ball_scenes under
   parity at 16 spp against ``goldens/ball_parity_4096avg.png``, a record
   (the environment dome is the 8x8 stand-in);
24. the scan engine (``render``) on ball_scenes at 512x512, 16 spp, depth
   50, sample chunks of 8 and pixel chunks of 65,536 (a 524,288-lane
   wavefront a chunk): kernels against plain versions on a 64x64, 4 spp,
   depth 8 image; B2 against the plain step on the first chunk's
   wavefront two bounces in (as in phase 5, at every G, with its time and
   bound); one render to warm up and three timed, every bounce one B2
   launch (50 a chunk) and no B1; no NaN; the image against
   ``render_regen``'s at the same settings under the image contract;
25. the same on cornell_boxes, B3 against its plain walk and B2 with its
   hit on that wavefront, every bounce one B3 and one B2 launch;
26. the sequential parity render (``seq_stale``) on ball_scenes at phase
   24's settings: one lane a pixel, every bounce one B2 parity launch and
   nothing else, the early exit, the image equal to the bit to the parity
   scan render at one sample a chunk;
27. ``render_resumable`` on ball_scenes at phase 24's settings with a
   checkpoint every 8 samples, stopped after its first checkpoint and run
   again: equal to phase 24's uninterrupted render to the bit;
28. the command line (``python -m srt_tpu_torch``) in a subprocess on
   cornell_boxes at 512x512, 16 spp, depth 50 with ``--engine regen``,
   ``--engine scan`` and ``--checkpoint``: each PNG equal to the
   in-process render's 8-bit values to the bit, the JSON metrics line
   parsed;
29. the scan engine's train step on ball_scenes at phase 6's size,
   ``{"tex_color"}``, Adam 1e-2: B2 and B5 against their plain versions
   (as in phase 5) on the step's 262,144-lane wavefront three bounces
   in, B5's time and bound there; one step to warm up and three timed,
   every bounce one B2 and one B5 launch, finite losses and gradient, the
   peak memory;
30. the scenes the kernels' gate refuses, at 256x256, 16 spp, depth 50
   through both engines: the mesh-medium box and cornell_boxes with its
   back wall tiled into 64 rects, the bounce plain (and the walk B3), no
   NaN, the tiled Cornell against cornell_boxes' own;
31. the float image atlas (A13): earth_sphere's atlas spliced to float
   (its values u8/255), B1, B2 and B5 on phases 17's and 19's wavefronts
   equal to the bit to the packed atlas's launches; the float atlas's
   render through B1 and its scan image equal to the packed one's; a
   ``{"tex_color"}`` step on the float atlas (B2, B5) and the
   ``{"atlas"}`` step at phase 6's settings (B2, the hybrid with B6);
32. MERL (A12): a seeded table through ``write_merl``/``read_merl`` on a
   70,200-triangle PLY blob in ``cornell_box``'s layout, ``lookup`` on
   the card against the CPU, the render at 512x512x16x50 through both
   engines (walk B3, bounce plain);
33. the mesh assets (A8): a bunny-sized PLY and a dragon under a
   temporary ``SRT_ASSETS``, ``cornell_box`` (B3 against its plain walk,
   the render) and ``teapot_scene`` with both (B4 against its plain walk,
   the render), the host's load and build seconds;
34. distribution (A11): ``render_sharded`` on a one-process NCCL group
   equal to ``render`` to the bit, the sharded train step of one NCCL
   process and of two gloo processes on the one card against the
   unsharded one, and ``python -m srt_tpu_torch.dist.multihost`` as two
   gloo processes on the one card against one process, to the bit;
35. the sphere BVH (A15): a seeded field of 10,000 spheres on
   random_scene's ground under its lights (``tests/_torch_scenes.py:
   sphere_field``, past the bounce kernels' gate of 4,096 spheres), its
   tree's walk against the sweep on 65,536 camera rays and on the same
   rays after two plain bounces (hit and material equal, ``t`` within
   2e-5, the normal within 2e-4, the winner equal; the longest walk's
   visits; each one's time), the same on a 40,000-sphere field, then
   ``render_regen`` at 512x512, 8 spp (cut from 16 for the budget), depth
   50 with ``sphere_bvh`` on and off: the plain bounce, no kernel, no NaN,
   the images within the image contract, both walls; the budget (about
   90 s) and the cut printed on the phase's line;
36. the scaling sweep (A16): ``python -m srt_tpu_torch.dist.scaling
   --devices 1 2`` on the one card, two gloo processes sharing it: the
   images equal to the bit, ``cards`` 1, its JSON line printed;
37. the tools (A16): ``python -m srt_tpu_torch.phases --scene ball_scenes
   --lanes 65536 --loop 4`` (every number finite and positive); two
   parity chunks of ball_scenes averaged by ``golden_avg`` against the
   parity golden (its PSNR finite); ``regions`` at 500x500, 4 spp over the
   four floor variants against ``goldens/soldier_scene_500.png``;
38. the fixed-order sums (ROADMAP C18): the film kernel
   (``csrc/film_sum.cu``) against its plain version on the CPU to the bit,
   sums and counts, twice, its per-pixel scratch back at 0 after each
   launch, on four seeded flushes (pixels of up to 256 records, runs of
   1,024 lanes, NaN and +-inf), on the flush layouts of the tests
   (``tests/_torch_flushes.py``: a pixel in every tile, tiles of one
   pixel, runs across tile edges, the edges of the kernel's row of seven
   records and of one thread's 16 lanes) and on flushes recorded in the
   ball_scenes B1 render, at 16 and at 1,024 spp, and the cornell_boxes
   per-bounce render, with its time, ``index_add_``'s and the bound; two
   ball_scenes B1 renders at 512x512x16x50 and two at 1,024 spp, and two
   cornell_boxes per-bounce renders at 512x512x16x50, each pair equal to
   the bit; the material-sum kernel (``csrc/segment_sum.cu``) on B5's
   per-lane outputs at 16,384 and 262,144 lanes, two launches equal to the
   bit and to its order of adds in torch on the CPU
   (``kernels/segment.py:material_sum_order``), every row of the table
   within the gradient contract of its plain version, timed against
   ``index_add_``; the
   regen-scan and scan ``{"tex_color"}`` train steps' loss and gradient
   twice from the same state, to the bit; the geometry step's the same,
   as a record;
39. ``python -m srt_tpu_torch.bench --engine both --min-seconds 0
   --matrix --matrix-out FILE`` in a subprocess: both engines, the
   ``tri_scene`` side cell, and every library scene at 64x64, 2 spp,
   depth 50 (cut from ``bench.py``'s 256x256x8), no NaN pixel, every key
   of ``bench.py``'s line and its artifact's.

Prints each phase's seconds, then one JSON line about the kernels, one
about the paths phases 24-39 drive (``paths``: each path's launches per
kernel and its wall), the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}`` as the last line.

``python3 chip_smoke.py --compare TREE [TREE ...]`` instead
times B1 (phase 3's and phase 17's random_scene wavefronts), B2 (the train
states of phases 5, 19 and 20, phase 21's parity wavefronts, the teapot's
and cornell_boxes' external hits), B3 (phase 7's cornell render wavefront
and ``final`` ground, phase 16's cornell train state), B4 on phase 10's
bounced teapot rays, B5 on phase 5's and phase 19's states, B6 on the
ball_scenes and random_scene train states, the ball_scenes and teapot
renders and the train steps from each checkout TREE in turns (see
``compare``), B1, B2, B3 and B6 also at every G where the checkout picks
one, the film kernel on phase 38's four recorded flushes and the material
sum at 16,384 and 262,144 lanes beside ``index_add_`` (CUDA events over a
loop of launches, over a CUDA graph's replay, and the profiler's device
rows), the profiler's kernel rows over a ball_scenes render and a train
step, and ``bench --spp 1024 --profile``'s device busy, for example the
parent commit unpacked with ``git archive`` under ``build/``, and fails
where two runs given the same inputs gave different outputs (SHA-256
digests of every kernel's inputs and per-lane outputs; the material sum's
table, whose order is the checkout's own, is only reported).
"""
from __future__ import annotations

import argparse
import contextlib
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


def timed(phase: int, fn, *args):
    """``fn(*args)``, its seconds logged as phase ``phase``'s."""
    t0 = time.time()
    out = fn(*args)
    log(f"[phase {phase}] {time.time() - t0:.1f} s")
    return out


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


def graph_ms(fn, reps: int = 50):
    """Milliseconds a call of ``fn`` over four replays of a CUDA graph of
    ``reps`` calls (no host between launches), or the capture's error."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
    except Exception as e:     # a launch the capture does not take
        torch.cuda.synchronize()
        return f"{type(e).__name__}: {e}"[:200]
    g.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(4):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (4 * reps)


def device_rows(fn) -> tuple:
    """``fn()`` once under ``torch.profiler`` (device rows only): ``(its
    result, {kernel: [launches, device microseconds]})``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.key: [e.count, e.self_device_time_total]
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}


def device_ms(fn, reps: int = 100) -> float:
    """The profiler's device time a call over ``reps`` calls of ``fn``,
    every device row summed."""
    import torch
    fn()
    torch.cuda.synchronize()
    _, rows = device_rows(lambda: [fn() for _ in range(reps)])
    return sum(us for _, us in rows.values()) / 1e3 / reps


def three_timers(fn) -> dict:
    """``fn``'s milliseconds a call three ways: CUDA events over a Python
    loop (``loop``, the least of two runs of 200; reads the host's issue
    interval below about 0.01 ms), over a CUDA graph's replay (``graph``)
    and the profiler's device rows (``device``)."""
    return {"loop": min(time_ms(fn, 200) for _ in range(2)),
            "graph": graph_ms(fn), "device": device_ms(fn)}


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


def bare_call(entry: str, args):
    """One bare launch of the library's ``entry`` on the argument struct
    ``args`` (held by the call), on the stream current at the call, so
    that a graph's capture takes it."""
    import ctypes

    import torch

    from srt_tpu_torch.kernels import build

    fn = getattr(build.load_library(), entry)
    addr = ctypes.addressof(args)

    def one():
        if fn(addr, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"{entry} launch failed ({args})")
    return one


def args_launch_ms(entry: str, args, reps: int) -> float:
    """Milliseconds per launch of the library's ``entry`` on the argument
    struct ``args``, built once: bare launches, as
    :func:`bare_launch_ms` times them."""
    return time_ms(bare_call(entry, args), reps)


def kernel_registers(report: str, kernel: str, spills: bool = False) -> dict:
    """``ptxas``' registers of each instantiation of the CUDA kernel
    ``kernel``, keyed by its template's int arguments, each followed by a
    comma, then its bool arguments as digits (B1's ``kMoving kRich``, B2's
    ``kExt kMoving kRich kParity``, B5's ``K,kRich``),
    from the build's ``-Xptxas -v`` report; with ``spills`` each value is
    ``[registers, bytes of spill stores]``."""
    import re
    mangled = f"{len(kernel)}{kernel}"
    out, entry, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and mangled in entry:
            key = ("".join(k + "," for k in re.findall(r"Li(\d+)E", entry))
                   + "".join(re.findall(r"Lb(\d)E", entry))) or "-"
            out[key] = [int(m.group(1)), spill] if spills else int(m.group(1))
            entry = None
    return out


# Where the host picks a kernel's G: the module of srt_tpu_torch.kernels,
# its picking function and its tuple of Gs. SWEEP is the threads a lane's
# (a ray's) sphere sweep runs on in B1, B2 and B6; WALK the threads a
# ray's triangle walk runs on in B3.
SWEEP = ("bounce", "sweep_shares", "SHARES")
WALK = ("intersect", "walk_shares", "WALK_SHARES")


def picker(kind: tuple):
    """``(module, picking function's name, its Gs)`` of ``kind``, from the
    checkout's package; the Gs are () where the module has none."""
    import importlib

    mod = importlib.import_module(f"srt_tpu_torch.kernels.{kind[0]}")
    return mod, kind[1], getattr(mod, kind[2], ())


@contextlib.contextmanager
def shares(g: int, kind: tuple = SWEEP):
    """The kernels of ``kind`` launched with ``g`` threads a lane or a
    ray: the wrappers' pick replaced."""
    mod, name, _ = picker(kind)
    pick = getattr(mod, name)
    setattr(mod, name, lambda *a, **k: g)
    try:
        yield
    finally:
        setattr(mod, name, pick)


def b3_b6_registers(label: str) -> None:
    """Logs ``ptxas``' [registers, spill stores] of B3 and B6 by G."""
    from srt_tpu_torch.kernels import build

    report = build.ptxas_report()
    log(f"[{label}] ptxas [registers, spill stores] of B3 by G "
        f"{json.dumps(kernel_registers(report, 'intersect_tris_kernel', True))}"
        f", of B6 by G "
        f"{json.dumps(kernel_registers(report, 'sphere_winner_kernel', True))}")


def at_every_g(name: str, kind: tuple, call, out_ref, time_g) -> dict:
    """``call()`` at each G of ``kind``, each output equal to ``out_ref``
    (the launch at the host's G) to the bit; returns ``time_g()``'s ms at
    each G."""
    import torch

    ms = {}
    for g in picker(kind)[2]:
        with shares(g, kind):
            out = call()
            torch.cuda.synchronize()
            bad = [k for k, (a, b) in enumerate(zip(out, out_ref))
                   if not same_bits(a, b)]
            if bad:
                raise AssertionError(f"{name} at G={g}: outputs {bad} "
                                     f"differ from the host's G")
            ms[g] = min(time_g() for _ in range(2))
    return ms


def same_bits(a, b) -> bool:
    """The two tensors hold the same bits (NaN included)."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def b1_shares(label: str, inp, mid, spec, st_ref: dict) -> None:
    """B1 at every G of ``kernels/bounce.py:SHARES`` on the wavefront
    ``mid``: each launch's wavefront equal to ``st_ref`` (the launch at the
    host's G) to the bit, and the ms per bare launch at each G."""
    import torch

    from srt_tpu_torch.kernels import bounce as kb

    picked = kb.sweep_shares(mid["alive"].shape[0], inp.fields["n_sph"])
    ms = {}
    for g in kb.SHARES:
        with shares(g):
            st = clone(mid)
            kb.regen_bounce(inp, st, spec)
            torch.cuda.synchronize()
            bad = [k for k in st_ref if not same_bits(st[k], st_ref[k])]
            if bad:
                raise AssertionError(f"B1 {label} at G={g}: {bad} differ "
                                     f"from G={picked}")
            ms[g] = min(b1_launch_ms(inp, mid, spec, 50) for _ in range(2))
    log(f"[shares-{label}] B1 at G = {list(ms)}: every output equal to the "
        f"bit; the host picks G={picked}; ms per bare launch by G "
        f"{json.dumps(ms)}")


def b2_shares(label: str, scene, flags, tables, st, step, tri,
              out_ref: dict) -> None:
    """B2 at every G of ``kernels/bounce.py:SHARES`` on the state ``st``:
    each launch's outputs equal to ``out_ref`` (the launch at the host's
    G) to the bit, and the ms per bare launch at each G."""
    import torch

    from srt_tpu_torch.kernels import bounce as kb

    picked = kb.fwd_args(scene, flags, tables, st, step, tri)[0].shares
    ms = {}
    for g in kb.SHARES:
        with shares(g):
            out = kb.bounce_fwd(scene, flags, tables, st, step, tri)
            torch.cuda.synchronize()
            bad = [k for k in out_ref if not same_bits(out[k], out_ref[k])]
            if bad:
                raise AssertionError(f"B2 {label} at G={g}: {bad} differ "
                                     f"from G={picked}")
            ms[g] = min(b2_launch_ms(scene, flags, tables, st, step, tri)
                        for _ in range(2))
    log(f"[shares-{label}] B2 at G = {list(ms)}: every output equal to the "
        f"bit; the host picks G={picked}; ms per bare launch by G "
        f"{json.dumps(ms)}")


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


def b2_launch_ms(scene, flags, tables, st, step, tri=None,
                 reps: int = 200) -> float:
    """Milliseconds per bare B2 launch on the state ``st``."""
    import ctypes

    from srt_tpu_torch.kernels import bounce as kb

    return bare_launch_ms(
        "srt_bounce", ctypes.sizeof(kb._BounceArgs),
        lambda: kb.bounce_fwd(scene, flags, tables, st, step, tri), reps)


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
    b1_shares("ball_scenes", inp, mid, spec, st_k)

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
    log(f"[bounce] ptxas [registers, spill stores] of B1 by G,kMoving kRich "
        f"{json.dumps(kernel_registers(report, 'regen_bounce_kernel', True))}"
        f", of B2 by G,kExt kMoving kRich kParity "
        f"{json.dumps(kernel_registers(report, 'bounce_kernel', True))}")

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


def phase_render(scene, cam, ppm) -> tuple[int, int]:
    """Phase 4: the render path through B1 and the film kernel; returns
    their launches."""
    from srt_tpu_torch.kernels import launch_counts as lc, reset_launch_counts
    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, render_regen

    cfg = RenderConfig(**MAIN)
    t0 = time.time()
    render_regen(scene, cam, cfg)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    reset_launch_counts()
    runs = [render_regen(scene, cam, cfg, metrics=True)
            for _ in range(MAIN_REPS)]
    launches, flushes = lc()["B1"], lc()["film_sum"]
    bounces = sum(m.bounces for _, m in runs)
    if not launches == flushes == bounces or launches == 0:
        raise AssertionError(f"{launches} kernel launches and {flushes} "
                             f"film launches for {bounces} bounces")
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
        f"{nan_pixels}, {launches} B1 and {flushes} film launches, "
        f"{json.dumps(met.to_dict())}")
    if ppm:
        from srt_tpu_torch.io.image import write_ppm
        write_ppm(ppm, np.sqrt(np.clip(img, 0.0, 1.0)))
    return launches, flushes


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
    for i in range(4):
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


def b5_shape(rich: bool) -> str:
    """B5's width K and passes P for one instantiation, with ``ptxas``'
    registers and bytes of spill stores."""
    from srt_tpu_torch.kernels import build

    regs = kernel_registers(build.ptxas_report(), "bounce_bwd_kernel", True)
    (key, shape), = [(k, v) for k, v in regs.items()
                     if k.endswith(str(int(rich)))]
    passes = build.load_library().srt_bounce_bwd_passes(int(rich))
    return (f"K {key.split(',')[0]}, P {passes}, registers and spill stores "
            f"{shape}")


def check_b5(label: str, scene, flags, tables, st, spec,
             alive_after) -> tuple[dict, dict]:
    """One launch of B5 against torch.autograd of the plain step on the
    state ``st``, under the gradient contract, with seeded cotangents;
    the (M, 14) material sums against the plain ones. The cotangent of o,
    d and beta is zero where the step ends the path (``alive_after``
    false), as in the engine: a finished lane's o, d, beta are never read
    again (the kernels leave them as they were, the plain step overwrites
    beta). Returns the per-lane gradients' metrics and the cotangents."""
    import numpy as np
    import torch

    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.utils import contract

    n = st["o"].shape[0]
    r = np.random.default_rng(2)
    keep = alive_after[:, None].float()
    ct = {k: torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32))
          .to(st["o"].device) for k in kbb.ROWS}
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
        raise AssertionError(f"B5 {label} material sums differ: max rel "
                             f"{mat_rel}")
    log(f"[{label}-bwd] {n} lanes, {int(st['alive'].sum())} live: d_state "
        f"{json.dumps(m5)}, (M,14) sums max |d| / max|ref| {mat_rel:.3e}")
    return m5, ct


def phase_train_kernels(scene, cam, dev) -> list:
    """Phase 5: kernels B2 and B5 against their plain versions."""
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
    b2_shares("train", scene, flags, tables, st, spec, None, out_k)

    m5, ct = check_b5("train", scene, flags, tables, st, spec,
                      out_p["alive"])

    # kernel times: the bare launch on arguments built once, so the
    # wrapper's checks and allocations stay out of the timed loop
    from srt_tpu_torch.kernels.build import launch
    reps_k, reps_p = 200, 5
    bargs, bargs_out = kbb.bwd_args(scene, flags, tables, st, ct, spec)
    fwd_ms = [b2_launch_ms(scene, flags, tables, st, spec, reps=reps_k)
              for _ in range(2)]
    fwd_plain = time_ms(lambda: kb.bounce_step_ref(
        scene, flags, tables["mat"], st, spec), reps_p)
    bwd_ms = [time_ms(lambda: launch("srt_bounce_bwd", bargs, dev), reps_k)
              for _ in range(2)]
    bwd_plain = time_ms(lambda: kbb.bounce_bwd_reference(
        scene, flags, tables["mat"], st, ct, spec), reps_p)
    log(f"[train-kernels] ms per launch at {n} lanes: B2 {fwd_ms} (plain "
        f"step {fwd_plain}), B5 {bwd_ms} (plain autograd {bwd_plain}; "
        f"{b5_shape(False)})")

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
                reset=None, engine: str = "regen") -> tuple:
    """``make_train_step`` on ``scene`` at ``size`` (width, spp, depth)
    with phase 6's engine (or the scan engine), optimiser and target: one
    step (seed 0) to warm up, then ``reset()`` when given, then ``steps``
    timed steps with seeds 1, 2, ... Returns the step, the warm-up
    seconds, the losses (the warm-up's first) and the step walls in
    seconds."""
    import torch

    from srt_tpu_torch import make_train_step

    w = size["width"]
    step = make_train_step(scene, cam, params, width=w, height=w,
                           spp=size["spp"], max_depth=size["max_depth"],
                           lr=TRAIN_LR, engine=engine,
                           engine_kw=TRAIN_ENGINE if engine == "regen"
                           else None, device=dev)
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


def phase_train(scene, cam, dev) -> tuple[int, int, int]:
    """Phase 6: the train path; returns the B2, B5 and material-sum
    launches of the timed steps."""
    from srt_tpu_torch.kernels import launch_counts as lc, reset_launch_counts
    import numpy as np

    from srt_tpu_torch.render.regen_scan import steps_for

    w, spp = TRAIN["width"], TRAIN["spp"]
    rays = w * w * spp

    step, warmup_s, (loss0, *losses), walls = train_walls(
        scene, cam, {"tex_color": scene.tex_color}, TRAIN, dev, TRAIN_STEPS,
        reset_launch_counts)
    fwd, bwd, sums = lc()["B2"], lc()["B5"], lc()["segment_sum"]
    n_steps = steps_for(rays, TRAIN_ENGINE["wavefront"],
                        TRAIN_ENGINE["depth_budget"], TRAIN["max_depth"],
                        drain=TRAIN_ENGINE["drain"])
    if not fwd == bwd == sums == n_steps * TRAIN_STEPS:
        raise AssertionError(f"{fwd} forward, {bwd} backward and {sums} "
                             f"material-sum launches for {TRAIN_STEPS} steps "
                             f"of {n_steps} bounces")
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
        f"losses {[loss0] + losses}, {fwd} B2, {bwd} B5 and {sums} "
        f"material-sum launches, tex_color gradient finite, nonzero on rows "
        f"{const}")
    return fwd, bwd, sums


def step_wavefront(scene, cam, dev, row: int = 256, flags=None) -> tuple:
    """A mid-flight 65,536-lane wavefront of the per-bounce render path,
    with the scene's ``flags`` (its own by default; the parity flags for
    phase 21): the work cursor at image row ``row``, mid-image by default,
    three plain bounces, a lane that ends taking the next work item, then
    a seeded half of the lanes marked dead.
    Returns the bounce's state (B2's layout), the render's inputs, and the
    wavefront's first rays (the camera rays, ``o`` and ``d``)."""
    import numpy as np
    import torch

    from srt_tpu_torch.core.sobol import sobol_points
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.render.intersect import intersect_tris_any
    from srt_tpu_torch.scene.ir import SceneFlags

    flags = SceneFlags.of(scene) if flags is None else flags
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
        tri = (intersect_tris_any(scene, state["o"], state["d"])
               if scene.n_tris else None)
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
    """Phase 7 on one input: B3 against the plain walk, and at every G
    equal to the bit to the host's G; times (at each G) and bound."""
    import torch

    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.kernels.build import launch

    tables = ki.pack_tables(scene)
    t, u, v, idx = out = ki.intersect_tris(scene, tables, o, d)
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
    def launch_ms():
        args, args_out = ki.kernel_args(tables, o, d)
        return time_ms(lambda: launch("srt_intersect_tris", args, o.device),
                       200)
    kern_ms = [launch_ms() for _ in range(2)]
    shares_ms = at_every_g(
        f"B3 {label}", WALK, lambda: ki.intersect_tris(scene, tables, o, d),
        out, launch_ms)
    plain_ms = time_ms(lambda: ki.intersect_tris_reference(scene, o, d), 3)
    n = o.shape[0]
    # bytes: the rays (o, d in; t, u, v, idx out) and the tables at what
    # the function needs of them: a node's box and its skip, first and
    # count, a triangle's three corners, 36 B each (the records' padding
    # and the kernel's edges do not count)
    n_bytes = n * (24 + 16) + 36 * (scene.n_bvh_nodes + scene.n_tris)
    ops = (n * OPS_RAY + int(visits.sum()) * OPS_SLAB
           + int(tests.sum()) * OPS_TRI)
    ms_bound, by = bound(n_bytes, ops)
    picked = ki.kernel_args(tables, o, d)[0].shares
    log(f"[tris-{label}] {n} rays, {scene.n_tris} triangles, "
        f"{scene.n_bvh_nodes} nodes: hits {int(hit.sum())} and indices "
        f"equal, max |dt| {err['t']:.3e} |du| {err['u']:.3e} |dv| "
        f"{err['v']:.3e}; per ray {float(visits.float().mean()):.2f} node "
        f"visits, {float(tests.float().mean()):.2f} triangle tests; ms per "
        f"launch {kern_ms} at the host's G={picked}, plain {plain_ms:.3f}, "
        f"bound {ms_bound:.6f} ({by}); at G = {list(shares_ms)} every "
        f"output equal to the bit, ms by G {json.dumps(shares_ms)}")
    return {"max_abs_err": max(err.values()), "ms": min(kern_ms),
            "plain_ms": plain_ms, "bound_ms": ms_bound, "bound_by": by}


def phase_tri_kernels(scene, cam, dev) -> tuple[dict, dict]:
    """Phases 7 and 8: B3 on both inputs, B2's external-hit mode on (a)."""
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.scene.ir import SceneFlags

    st, inp, step, _ = step_wavefront(scene, cam, dev)
    b3_b6_registers("tris")
    b3 = check_tri_kernel("cornell", scene, st["o"], st["d"])
    ground = check_tri_kernel("final-ground", *ground_field(dev))
    b3["max_abs_err"] = max(b3["max_abs_err"], ground["max_abs_err"])

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
    from _torch_census import bounce_census, parity_census

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.utils import contract

    dev = st["o"].device
    out_k = kb.bounce_fwd(scene, flags, tables, st, step, tri)
    out_p = kb.bounce_step_ref(scene, flags, tables["mat"], st, step, tri)
    torch.cuda.synchronize()
    if not torch.equal(out_k["depth"], out_p["depth"]):
        raise AssertionError(f"B2 {label}: depth differs")
    keys = ("alive", "d", "beta", "radiance")
    planes = keys + (("stale",) if flags.ref_parity else ())
    m = contract.check_bounce({k: out_p[k].cpu().numpy() for k in planes},
                              {k: out_k[k].cpu().numpy() for k in planes})
    n = st["o"].shape[0]
    n_live = int(st["alive"].sum())
    n_tri = 0 if tri is None else int((st["alive"] & (tri[0] < 3e38)).sum())
    kern_ms = [b2_launch_ms(scene, flags, tables, st, step, tri)
               for _ in range(2)]
    plain_ms = time_ms(lambda: kb.bounce_step_ref(
        scene, flags, tables["mat"], st, step, tri), 5)
    c = bounce_census(scene, st["o"], st["d"], st["time"], st["salt"],
                      st["depth"], st["alive"], tri)
    ops = shade_ops(scene, flags, c) + n_tri * OPS_TRI_HIT
    if flags.ref_parity:
        # a parity round samples, evaluates one pdf and the lights' pdfs
        # as the default draw does: the census's retry rounds each add a
        # shading's operations
        c.update(parity_census(scene, flags, st, tri))
        ops += c["retry_rounds"] * OPS_SHADE
    # a lane reads 57 B, 73 B with a triangle hit, and writes 53 B, 57 B
    # with the parity plane
    ms_bound, by = bound(n * (57 + (0 if tri is None else 16) + 53
                              + (4 if flags.ref_parity else 0)), ops)
    log(f"[bounce-{label}] {n} lanes, {n_live} live, {n_tri} on a "
        f"triangle: depth exact, {json.dumps(m)}; shaded {json.dumps(c)}; "
        f"ms per launch {kern_ms}, plain {plain_ms:.3f}, bound "
        f"{ms_bound:.6f} ({by})")
    b2_shares(label, scene, flags, tables, st, step, tri, out_k)
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


def phase_tri_render(scene, cam) -> tuple[int, int, int]:
    """Phase 9: the triangle render path; returns the B3, B2 and film
    launches of the timed renders."""
    from srt_tpu_torch.kernels import launch_counts as lc, reset_launch_counts
    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, render_regen
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
    reset_launch_counts()
    runs = []
    for _ in range(TRI_MAIN_REPS):
        img, met = render_regen(scene, cam, cfg, metrics=True)
        runs.append((img.cpu().numpy(), met))
    c = lc()
    b3, b2, b1 = c["B3"], c["B2"] + c["B2 parity"], c["B1"]
    flushes = c["film_sum"]
    bounces = sum(m.bounces for _, m in runs)
    if not b3 == b2 == flushes == bounces or bounces == 0 or b1:
        raise AssertionError(f"{b3} B3, {b2} B2 and {flushes} film launches "
                             f"({b1} B1) for {bounces} bounces")
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
        f"nan_pixels {nan_pixels}, {b3} B3, {b2} B2 and {flushes} film "
        f"launches for {bounces} bounces, {json.dumps(met.to_dict())}")
    return b3, b2, flushes


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
    three, and B4's bound."""
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
    args, args_out = ki.big_kernel_args(big, o, d)
    args3, args3_out = ki.kernel_args(single, o, d)
    kern_ms, b3_ms = [], []
    for _ in range(2):
        kern_ms.append(time_ms(lambda: launch("srt_intersect_big", args,
                                              o.device), 50))
        b3_ms.append(time_ms(lambda: launch("srt_intersect_tris", args3,
                                            o.device), 50))
    plain_ms = time_ms(lambda: ki.intersect_tris_big_reference(scene, o, d),
                       2)
    # bytes: the rays (o, d in; t, u, v, idx out) and each record that
    # some ray read, at what the function needs of it: a node's box and
    # two link words, 32 bytes (top tree and clusters; the plain walk's
    # padding nodes hold no box of the mesh), a triangle's three corners,
    # 36 bytes
    n, nc = o.shape[0], scene.cl_tris.shape[0]
    node_cap = seen[1].shape[0] // nc
    n_nodes = big["clusters"][:, 3].long()
    real = (torch.arange(node_cap, device=o.device)[None]
            < n_nodes[:, None]).reshape(-1)
    n_read = [int(seen[0].sum()), int((seen[1] & real).sum()),
              int(seen[2].sum())]
    entered = int(seen[1].view(nc, -1).any(1).sum())
    n_bytes = n * (24 + 16) + 32 * (n_read[0] + n_read[1]) + 36 * n_read[2]
    ops = (n * OPS_RAY + int((top_v + cl_v).sum()) * OPS_SLAB
           + int(tests.sum()) * OPS_TRI)
    ms_bound, by = bound(n_bytes, ops)
    longest = int((top_v + cl_v).max())
    log(f"[big-{label}] {n} rays, {scene.n_tris} triangles in {nc} clusters "
        f"({entered} entered): hits {int(hit.sum())} and indices equal, max "
        f"|dt| {err['t']:.3e} |du| {err['u']:.3e} |dv| {err['v']:.3e}; B3 on "
        f"the same rays: hits and indices equal, max |d(t,u,v)| "
        f"{vs_b3:.3e}; per ray "
        f"{float(top_v.float().mean()):.2f} top visits, "
        f"{float(cl_v.float().mean()):.2f} cluster-node visits, "
        f"{float(tests.float().mean()):.2f} triangle tests (plain walk, "
        f"padding included); records read: {n_read[0]} top nodes, "
        f"{n_read[1]} cluster nodes, {n_read[2]} triangles, {n_bytes} bytes "
        f"with the rays; ms per launch B4 {kern_ms} (longest walk {longest} "
        f"visits), B3 {b3_ms}, plain {plain_ms:.3f}, bound {ms_bound:.6f} "
        f"({by})")
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
    from srt_tpu_torch.kernels import build
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.materials.materials import is_specular
    from srt_tpu_torch.render.integrator import apply_media
    from srt_tpu_torch.render.intersect import intersect_scene
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    # the record packing every render_regen on the scene does once
    pack_ms = time_ms(lambda: ki.pack_big_tables(scene), 3)
    big, single = ki.pack_big_tables(scene), ki.pack_tables(scene)
    report = build.ptxas_report()
    b4_regs = kernel_registers(report, "intersect_big_kernel", True)
    b3_regs = kernel_registers(report, "intersect_tris_kernel", True)
    log(f"[teapot] pack_big_tables {pack_ms:.3f} ms a call; B4 tables: "
        f"{big['top'].shape[0]} top records, {big['nodes'].shape[0]} cluster "
        f"nodes, {big['tris'].shape[0]} triangles, count_bits "
        f"{big['count_bits']}; ptxas registers and spill stores of B4 "
        f"{json.dumps(b4_regs)}, of B3 {json.dumps(b3_regs)}")
    # rows 448-455: the teapots' lower edge and the glass sphere's top
    st, inp, step, first = step_wavefront(scene, cam, dev, row=TEAPOT_ROW)
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
    b2_shares("teapot", scene, flags, tables, st, step, tri, out_k)
    kern_ms = [b2_launch_ms(scene, flags, tables, st, step, tri)
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
    from srt_tpu_torch.kernels import launch_counts as lc, reset_launch_counts
    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, render_regen
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
    reset_launch_counts()
    runs = []
    for _ in range(TRI_MAIN_REPS):
        img, met = render_regen(scene, cam, cfg, metrics=True)
        runs.append((img.cpu().numpy(), met))
    c = lc()
    b4, b2, b3, b1 = c["B4"], c["B2"] + c["B2 parity"], c["B3"], c["B1"]
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
    and ``t`` equal to the bit, and at every G equal to the bit to the
    host's G; its time per launch (at each G), the plain version's and
    the bound."""
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
    t, idx = out = ks.sphere_winner(scene, sph, o, d, time)
    torch.cuda.synchronize()
    if not torch.equal(idx, pidx):
        raise AssertionError(f"B6 {label}: index differs on "
                             f"{int((idx != pidx).sum())} rays")
    if not torch.equal(t, pt):
        raise AssertionError(f"B6 {label}: t differs on "
                             f"{int((t != pt).sum())} rays, max "
                             f"{float((t - pt).abs().max())}")
    def launch_ms():
        args, args_out = ks.kernel_args(sph, o, d, time, 1e-3)
        return time_ms(lambda: launch("srt_sphere_winner", args, o.device),
                       200)
    kern_ms = [launch_ms() for _ in range(2)]
    shares_ms = at_every_g(
        f"B6 {label}", SWEEP,
        lambda: ks.sphere_winner(scene, sph, o, d, time), out, launch_ms)
    plain_ms = time_ms(lambda: ks.sphere_winner_reference(scene, o, d, time),
                       5)
    n, s = o.shape[0], scene.n_spheres
    ms_bound, by = bound(n * (28 + 8) + 48 * s, n * s * OPS_SPHERE_MOVING)
    picked = ks.kernel_args(sph, o, d, time, 1e-3)[0].shares
    log(f"[winner-{label}] {n} rays, {s} spheres, {hits} hits: indices and "
        f"t equal to the bit; ms per launch {kern_ms} at the host's "
        f"G={picked}, plain {plain_ms:.3f}, bound {ms_bound:.6f} ({by}); at "
        f"G = {list(shares_ms)} every output equal to the bit, ms by G "
        f"{json.dumps(shares_ms)}")
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
    b3_b6_registers("winner")
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
    from srt_tpu_torch.kernels import launch_counts as lc
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
    launches = lc()["B1"]
    kb.regen_bounce(inp, st_k, spec)
    kb.regen_bounce_reference(inp, st_p, spec)
    torch.cuda.synchronize()
    if lc()["B1"] != launches + 1:
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
    from srt_tpu_torch.kernels import launch_counts as lc, reset_launch_counts
    import numpy as np
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.kernels import bounce_vjp as kv
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
    launches = lc()["B6"]
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
    if lc()["B6"] != launches + 1:
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
        reset_launch_counts()
    step, warmup_s, (loss0, *losses), walls = train_walls(
        scene, cam, {k: getattr(scene, k) for k in GEOM_PARAMS}, TRAIN, dev,
        TRAIN_STEPS, reset)
    fwd, b6, b5 = lc()["B2"], lc()["B6"], lc()["B5"]
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
    from srt_tpu_torch.kernels import launch_counts as lc, reset_launch_counts
    import numpy as np

    from srt_tpu_torch import get_scene
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import intersect as ki
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
    b3_b6_registers("cornell-train")
    b3_train = check_tri_kernel("cornell-train", scene, st["o"], st["d"])
    b2_train = check_b2("cornell-train", scene, flags, tables, st,
                                spec, ki.closest_tris(scene, walk, st["o"],
                                                      st["d"]))

    w, spp = CORNELL_TRAIN["width"], CORNELL_TRAIN["spp"]

    step, _, (loss0, loss), (wall,) = train_walls(
        scene, cam, {"tex_color": scene.tex_color}, CORNELL_TRAIN, dev, 1,
        reset_launch_counts)
    c = lc()
    b3, b2, b6, b5, b4 = c["B3"], c["B2"], c["B6"], c["B5"], c["B4"]
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
    from srt_tpu_torch.kernels import launch_counts as lc
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
        launches = lc()["B1"]
        kb.regen_bounce(inp, st_k, spec)
        kb.regen_bounce_reference(inp, st_p, spec)
        torch.cuda.synchronize()
        if lc()["B1"] != launches + 1:
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
        b1_shares(name, inp, mid, spec, st_k)
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
    st, inp, step, _ = step_wavefront(scene, cam, dev, row=FINAL_ROW)
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
    from srt_tpu_torch.kernels import launch_counts as lc, reset_launch_counts
    import warnings

    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, get_scene, render_regen

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene("random_scene", device=dev)
    cfg = RenderConfig(**MAIN)
    t0 = time.time()
    render_regen(scene, cam, cfg)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    reset_launch_counts()
    runs = []
    for _ in range(TRI_MAIN_REPS):
        img, met = render_regen(scene, cam, cfg, metrics=True)
        runs.append((img.cpu().numpy(), met))
    launches = lc()["B1"]
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
    from srt_tpu_torch.kernels import launch_counts as lc
    import numpy as np
    import torch
    from _torch_census import bounce_census

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.kernels.build import launch
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    log(f"[rich-bwd] B5 rich: {b5_shape(True)}")
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
        rich0 = lc()["B5 rich"]
        g_k, dmat_k = kbb.bounce_bwd(scene, flags, tables, st, ct, spec)
        g_p, dmat_p = kbb.bounce_bwd_reference(scene, flags, tables["mat"],
                                               st, ct, spec)
        torch.cuda.synchronize()
        if lc()["B5 rich"] != rich0 + 1:
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
        bargs, bargs_out = kbb.bwd_args(scene, flags, tables, st, ct, spec)
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
    from srt_tpu_torch.kernels import launch_counts as lc, reset_launch_counts
    import numpy as np
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.render.regen_scan import steps_for
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.trainbench import phase_walls

    def counts():
        c = lc()
        return c["B2"], c["B5"], c["B5 rich"], c["B6"]

    reset = reset_launch_counts

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


# phase 21: (scene, parity_no_stale) of B2's parity inputs
PARITY_CASES = (("ball_scenes", False), ("ball_scenes", True),
                ("cornell_boxes", False))
PARITY_MEAN = (0.05, 0.5)   # phase 22's images
GOLDEN_SPP = 64             # phase 23's cornell_boxes renders


def parity_scene(name: str, dev, no_stale: bool = False):
    """A library scene, its camera and its flags under the parity
    estimator (``parity_no_stale`` if asked)."""
    import warnings

    from srt_tpu_torch import RenderConfig, get_scene
    from srt_tpu_torch.render.api import scene_flags

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene(name, device=dev)
    cfg = RenderConfig(ref_parity=True, parity_no_stale=no_stale)
    return scene, cam, scene_flags(scene, cfg)


def phase_parity_kernel(dev) -> dict:
    """Phase 21: B2's parity instantiation against the plain step on the
    ``PARITY_CASES``; returns the kernels-line entry of B2 parity (the
    times and bound of the first case) and the cases."""
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.kernels.build import ptxas_report

    report = ptxas_report()
    log(f"[parity] ptxas [registers, spill stores] of B2 by G,kExt kMoving "
        f"kRich kParity "
        f"{json.dumps(kernel_registers(report, 'bounce_kernel', True))}; "
        f"of B1 by G,kMoving kRich "
        f"{json.dumps(kernel_registers(report, 'regen_bounce_kernel', True))}")
    cases = {}
    for name, no_stale in PARITY_CASES:
        scene, cam, flags = parity_scene(name, dev, no_stale)
        st, inp, step, _ = step_wavefront(scene, cam, dev, flags=flags)
        tri = None
        if scene.n_tris:
            tri = ki.closest_tris(scene, ki.pack_walk(scene), st["o"],
                                  st["d"])
        label = f"parity-{name}" + ("-no-stale" if no_stale else "")
        r = check_b2(label, scene, flags, inp.tables, st, step, tri)
        c = r["census"]
        want = (("retried", "stores", "slot_reads_0")
                + (() if no_stale else ("slot_reads_1e30",))
                if name == "ball_scenes" else ("drew",))
        missing = [k for k in want if not c[k]]
        if missing or (no_stale and c["slot_reads_1e30"]):
            raise AssertionError(f"B2 {label}: the state reaches no "
                                 f"{missing}: {c}")
        cases[label] = r
    first = cases[f"parity-{PARITY_CASES[0][0]}"]
    return {"name": "bounce_parity", "route": "cuda",
            "source": "srt_tpu_torch/csrc/bounce.cu",
            "replaces": "srt_tpu/pallas/bounce.py:1504",
            "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None,
            "cases": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")}
                      for k, r in cases.items()}}


def parity_renders(name: str, cfg, reps: int, dev) -> tuple:
    """``reps`` timed renders of ``name`` under ``cfg`` after one to warm
    up; checks every bounce launched one B2 parity, no B1, and one B3 on
    a triangle scene, and the images; returns (B2 parity launches, B3
    launches, the rates)."""
    from srt_tpu_torch.kernels import launch_counts as lc, reset_launch_counts
    import numpy as np
    import torch

    from srt_tpu_torch import render_regen

    scene, cam, _ = parity_scene(name, dev)
    t0 = time.time()
    render_regen(scene, cam, cfg)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    reset_launch_counts()
    runs = []
    for _ in range(reps):
        img, met = render_regen(scene, cam, cfg, metrics=True)
        runs.append((img.cpu().numpy(), met))
    c = lc()
    b2, b3, b1 = c["B2 parity"], c["B3"], c["B1"]
    bounces = sum(m.bounces for _, m in runs)
    if (b2 != bounces or c["B2"] != 0 or not bounces or b1
            or b3 != (bounces if scene.n_tris else 0)):
        raise AssertionError(f"{name} parity: {b2} B2 parity, {b3} B3 and "
                             f"{b1} B1 launches for {bounces} bounces")
    for img, met in runs:
        nan_pixels = int(np.isnan(img).sum())
        mean = float(img.mean())
        if (not np.isfinite(img).all() or nan_pixels or met.nan_scrubbed
                or not PARITY_MEAN[0] < mean < PARITY_MEAN[1]):
            raise AssertionError(f"{name} parity image: mean {mean}, nan "
                                 f"{nan_pixels}, scrubbed "
                                 f"{met.nan_scrubbed}")
    rates = sorted(m.primary_rays_per_sec for _, m in runs)
    log(f"[parity-main] {name} {cfg.width}x{cfg.height}x{cfg.spp} depth "
        f"{cfg.max_depth}, {reps} renders: median "
        f"{rates[len(rates) // 2]:.1f} primary rays/s (all {rates}), first "
        f"render {warmup_s:.3f}s, mean {mean:.5f}, nan_pixels {nan_pixels}, "
        f"{b2} B2 parity, {b3} B3, {b1} B1 launches for {bounces} bounces, "
        f"{json.dumps(met.to_dict())}")
    return b2, b3, rates


def phase_parity_render(dev) -> tuple:
    """Phase 22: the parity render path; returns its B2 parity and B3
    launches in the counted renders."""
    from srt_tpu_torch import RenderConfig, render_regen
    from srt_tpu_torch.utils import contract

    scene, cam, _ = parity_scene("ball_scenes", dev)
    small = RenderConfig(width=64, height=64, spp=4, max_depth=8,
                         wavefront=LANES, ref_parity=True)
    img_k = render_regen(scene, cam, small).cpu().numpy()
    img_p = render_regen(scene, cam, small, plain=True).cpu().numpy()
    mi = contract.check_image(img_k, img_p)
    log(f"[parity-image] ball_scenes 64x64x4 depth 8 kernel vs plain: "
        f"{json.dumps(mi)}")
    del scene
    cfg = RenderConfig(**MAIN, ref_parity=True)
    b2, _, _ = parity_renders("ball_scenes", cfg, TRI_MAIN_REPS, dev)
    b2_c, b3, _ = parity_renders("cornell_boxes", cfg, 1, dev)
    return b2 + b2_c, b3


def phase_golden(root: str, dev) -> None:
    """Phase 23: the port's golden tool on the card: cornell_boxes at
    512x512 with and without parity against the asset-free golden, and
    ball_scenes under parity against the reference-parity golden, a
    record only (the environment dome is the 8x8 stand-in here)."""
    import math
    import shutil
    import tempfile

    from srt_tpu_torch import golden

    out_dir = tempfile.mkdtemp()
    runs = [("cornell_boxes", GOLDEN_SPP, "cornell_boxes_512.png", False),
            ("cornell_boxes", GOLDEN_SPP, "cornell_boxes_512.png", True),
            ("ball_scenes", MAIN["spp"], "ball_parity_4096avg.png", True)]
    recs = []
    try:
        for name, spp, gold, parity in runs:
            argv = ["--scene", name, "--size", "512", "--spp", str(spp),
                    "--golden", os.path.join(root, "goldens", gold),
                    "--out-dir", out_dir, "--device", str(dev)]
            rec = golden.run(golden.parse_args(
                argv + (["--ref-parity"] if parity else [])))
            if not all(math.isfinite(rec[k]) for k in
                       ("psnr_db", "psnr_ds_db", "mean_ours")):
                raise AssertionError(f"golden {name}: {rec}")
            log(f"[golden] {'parity' if parity else 'default'} "
                f"{json.dumps(rec)}")
            recs.append(rec)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    # diffuse surfaces lit by NEE only (GOLDEN.md:17-24): parity loses the
    # indirect light, so shadowed walls go dark and the tonemapped image
    # the golden tool compares is darker, though the light-only draw's
    # division by the 50/50 mixture pdf doubles the direct light and the
    # linear mean comes out a few percent brighter (phase 22; in JAX too,
    # tests/test_torch_parity_tris.py)
    if not recs[1]["mean_ours"] < recs[0]["mean_ours"]:
        raise AssertionError(f"cornell_boxes parity not darker: {recs}")


# --- phases 24-30: the scan engine, checkpoints, the command line, A7 ---

#: the scan engine at the main cell: pixel chunks of 65,536 and sample
#: chunks of 8, so a chunk is a 524,288-lane wavefront
SCAN = dict(MAIN, sample_chunk=8, pixel_chunk=LANES)
SCAN_REPS = 3
#: phase 30: the A7 scenes, the width cut to 256 because the plain torch
#: bounce paces them
A7 = dict(SCAN, width=256, height=256)


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from srt_tpu_torch.kernels import reset_launch_counts
    reset_launch_counts()


def read_counts() -> dict:
    """Every kernel's launches since :func:`reset_counts`, B2's default and
    parity instantiations apart."""
    from srt_tpu_torch.kernels import launch_counts
    return launch_counts()


def scan_chunks(cfg) -> int:
    """The scan engine's chunks of one render: pixel chunks × sample
    chunks."""
    n = cfg.width * cfg.height
    chunk = 1 if cfg.seq_stale and cfg.ref_parity else min(cfg.sample_chunk,
                                                            cfg.spp)
    return -(-n // cfg.pixel_chunk) * -(-cfg.spp // chunk)


def scan_state(scene, cam, cfg, bounces: int) -> dict:
    """The first chunk's wavefront of the scan engine (its pixel chunk ×
    sample chunk, 524,288 lanes at :data:`SCAN`) after ``bounces`` kernel
    bounces."""
    import torch

    from srt_tpu_torch.render.api import chunk_rays, render_setup
    from srt_tpu_torch.render.integrator import initial_state

    dev = scene.device
    _, jitter, route = render_setup(scene, cfg)
    rays, salt = chunk_rays(
        cam, torch.arange(min(cfg.pixel_chunk, cfg.width * cfg.height),
                          device=dev), 0, jitter, cfg.seed, width=cfg.width,
        height=cfg.height, n_samples=min(cfg.sample_chunk, cfg.spp))
    st = initial_state(rays, salt)
    with torch.no_grad():
        for _ in range(bounces):
            st = route(st)
    return st


def scan_runs(label: str, fn, scene, cam, cfg, reps: int) -> tuple:
    """``fn`` (``render`` or ``render_regen``) once to warm up, then
    ``reps`` times with metrics from counts of 0; checks the images
    (finite, no NaN, a sane mean). Returns the images (on the card), the
    metrics, the launches and the warm-up seconds."""
    import numpy as np
    import torch

    t0 = time.time()
    fn(scene, cam, cfg)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    reset_counts()
    runs = [fn(scene, cam, cfg, metrics=True) for _ in range(reps)]
    counts = read_counts()
    for img, met in runs:
        a = img.cpu().numpy()
        if (not np.isfinite(a).all() or met.nan_scrubbed
                or not 0.0 < float(a.mean()) < 1.0):
            raise AssertionError(f"{label}: mean {a.mean()}, nan "
                                 f"{int(np.isnan(a).sum())}, scrubbed "
                                 f"{met.nan_scrubbed}")
    rates = sorted(m.primary_rays_per_sec for _, m in runs)
    walls = sorted(m.wall_s for _, m in runs)
    log(f"[{label}] {cfg.width}x{cfg.height}x{cfg.spp} depth "
        f"{cfg.max_depth}, {reps} renders: median "
        f"{rates[len(rates) // 2]:.1f} primary rays/s (all {rates}), walls "
        f"{walls} s, first render {warmup_s:.3f} s, launches "
        f"{json.dumps(counts)}, {json.dumps(runs[-1][1].to_dict())}")
    return [img for img, _ in runs], [m for _, m in runs], counts, warmup_s


def path_record(name: str, counts: dict, metrics: list) -> dict:
    """A path's entry in the ``paths`` line: its launches per kernel and
    its median wall."""
    walls = sorted(m.wall_s for m in metrics)
    return {"name": name, "launches": {k: v for k, v in counts.items() if v},
            "wall_s": walls[len(walls) // 2]}


def check_scan_path(label: str, scene, cam, reps: int) -> dict:
    """Phases 24-25: the scan engine on a library scene at :data:`SCAN`:
    kernels against plain versions on a 64x64, 4 spp, depth 8 image; the
    kernels against their plain versions on the first chunk's 524,288-lane
    wavefront two bounces in (B3, then B2 with its hit, on a triangle
    scene); one render to warm up and ``reps`` timed, every bounce one B2
    launch (and one B3 on a triangle scene), no B1; the image against
    ``render_regen``'s at the same settings."""
    import torch

    from srt_tpu_torch import RenderConfig, render, render_regen
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.kernels.bounce import StepSpec
    from srt_tpu_torch.render.api import scene_flags
    from srt_tpu_torch.utils import contract

    small = RenderConfig(width=64, height=64, spp=4, max_depth=8)
    mi = contract.check_image(render(scene, cam, small).cpu().numpy(),
                              render(scene, cam, small,
                                     plain=True).cpu().numpy())
    log(f"[{label}-image] 64x64x4 depth 8 kernels vs plain: "
        f"{json.dumps(mi)}")
    cfg = RenderConfig(**SCAN)
    st = scan_state(scene, cam, cfg, 2)
    flags = scene_flags(scene, cfg)
    tri, b3 = None, None
    if scene.n_tris:
        b3 = check_tri_kernel(f"{label}-wavefront", scene, st["o"], st["d"])
        tri = ki.closest_tris(scene, ki.pack_walk(scene), st["o"], st["d"])
    b2 = check_b2(label, scene, flags, kb.build_tables(scene, flags), st,
                  StepSpec(max_depth=cfg.max_depth), tri)
    del st, tri
    imgs, mets, counts, warmup_s = scan_runs(label, render, scene, cam, cfg,
                                             reps)
    want = reps * scan_chunks(cfg) * cfg.max_depth
    if (counts["B2"] != want or counts["B3"] != (want if scene.n_tris else 0)
            or counts["B1"] or counts["B4"] or counts["B2 parity"]
            or any(m.bounces != want // reps for m in mets)):
        raise AssertionError(f"{label}: launches {counts} for {want} "
                             f"bounces")
    regen = render_regen(scene, cam, cfg).cpu().numpy()
    mr = contract.check_image(imgs[0].cpu().numpy(), regen)
    log(f"[{label}] scan against render_regen at the same settings: "
        f"{json.dumps(mr)}")
    torch.cuda.synchronize()
    return {"img": imgs[0], "counts": counts, "b2": b2, "b3": b3,
            "path": path_record(label, counts, mets)}


def phase_seq_stale(dev) -> dict:
    """Phase 26: the sequential parity render (``seq_stale``) on
    ball_scenes at :data:`SCAN`: one lane a pixel, the heap-slot plane
    carried over each pixel's 16 samples, every bounce one B2 parity
    launch and nothing else; the image equal to the bit to the parity
    scan render at one sample a chunk (the carried plane is inert)."""
    import torch

    from srt_tpu_torch import RenderConfig, render

    scene, cam, _ = parity_scene("ball_scenes", dev)
    cfg = RenderConfig(**SCAN, ref_parity=True, seq_stale=True)
    imgs, mets, counts, _ = scan_runs("seq-stale", render, scene, cam, cfg,
                                      1)
    if (counts["B2 parity"] != mets[0].bounces or not mets[0].bounces
            or counts["B2"] or counts["B1"] or counts["B3"]):
        raise AssertionError(f"seq_stale: launches {counts} for "
                             f"{mets[0].bounces} bounces")
    if mets[0].bounces >= scan_chunks(cfg) * cfg.max_depth:
        raise AssertionError(f"seq_stale took every bounce: {mets[0]}")
    same = render(scene, cam, RenderConfig(**dict(SCAN, sample_chunk=1),
                                           ref_parity=True))
    if not torch.equal(same, imgs[0]):
        raise AssertionError("seq_stale differs from the parity scan render")
    log(f"[seq-stale] equal to the bit to the parity scan render at one "
        f"sample a chunk; {mets[0].bounces} of "
        f"{scan_chunks(cfg) * cfg.max_depth} bounces (the early exit)")
    return {"counts": counts, "path": path_record("seq_stale ball_scenes",
                                                  counts, mets)}


def phase_resumable(scene, cam, full) -> dict:
    """Phase 27: ``render_resumable`` on ball_scenes at :data:`SCAN` with a
    checkpoint every 8 samples, stopped right after its first checkpoint
    and run again: it resumes from the file and equals the uninterrupted
    ``render`` (phase 24's image ``full``) to the bit."""
    import shutil
    import tempfile

    import torch

    from srt_tpu_torch import RenderConfig
    from srt_tpu_torch.utils import checkpoint as ck

    cfg = RenderConfig(**SCAN)
    work = tempfile.mkdtemp()
    path = os.path.join(work, "ball.npz")
    save = ck.save_render_ckpt

    class Stop(Exception):
        pass

    def save_then_stop(*args, **kw):
        save(*args, **kw)
        raise Stop
    reset_counts()
    t0 = time.time()
    ck.save_render_ckpt = save_then_stop
    try:
        ck.render_resumable(scene, cam, cfg, path, ckpt_every_spp=8)
        raise AssertionError("render_resumable saved no checkpoint")
    except Stop:
        pass
    finally:
        ck.save_render_ckpt = save
    try:
        done = ck.load_render_ckpt(path, cfg)[1]
        img, met = ck.render_resumable(scene, cam, cfg, path,
                                       ckpt_every_spp=8, metrics=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        left = os.path.exists(path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if done != 8 or left or not torch.equal(img, full):
        raise AssertionError(f"resumable: {done} samples in the checkpoint, "
                             f"file left {left}, equal "
                             f"{torch.equal(img, full)}")
    want = scan_chunks(cfg) * cfg.max_depth
    if counts["B2"] != want or counts["B1"]:
        raise AssertionError(f"resumable: launches {counts}, want {want}")
    met.wall_s = wall
    log(f"[resumable] stopped after the checkpoint at {done} of {cfg.spp} "
        f"samples, resumed: equal to the uninterrupted render to the bit; "
        f"{json.dumps(counts)} over both runs, {wall:.3f} s")
    return {"counts": counts, "path": path_record(
        "render_resumable ball_scenes", counts, [met])}


def phase_cli(root: str, scene, cam, scan_img) -> list:
    """Phase 28: ``python -m srt_tpu_torch`` in a subprocess on
    cornell_boxes at 512x512, 16 spp, depth 50 with ``--engine regen``,
    ``--engine scan`` and ``--checkpoint``, each ``--metrics``: the PNG,
    read back with ``read_png``, against the in-process tonemapped
    render's 8-bit values to the bit (the scan engine's, phase 25's image;
    the regeneration engine's, whose film kernel adds in lane order), the
    JSON line parsed with its route and the launches the subprocess read
    from the kernels' counters: one B3 and one B2 a bounce, and on the
    regeneration engine one film launch a bounce, nothing else."""
    import shutil
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, render_regen
    from srt_tpu_torch.io.image import read_png
    from srt_tpu_torch.render import film

    def eight_bit(img):
        return film.to_uint8(film.tonemap(img)).cpu().numpy()

    scan8 = eight_bit(scan_img)
    regen8 = eight_bit(render_regen(scene, cam, RenderConfig(**MAIN)))
    work = tempfile.mkdtemp()
    env = dict(os.environ, PYTHONPATH=root)
    base = [sys.executable, "-m", "srt_tpu_torch", "--scene",
            "cornell_boxes", "--width", str(MAIN["width"]), "--spp",
            str(MAIN["spp"]), "--max-depth", str(MAIN["max_depth"]),
            "--sample-chunk", str(SCAN["sample_chunk"]), "--device",
            str(scene.device), "--metrics"]
    records = []
    try:
        for label, extra, want in (
                ("regen", ["--engine", "regen"], regen8),
                ("scan", ["--engine", "scan"], scan8),
                ("checkpoint", ["--checkpoint",
                                os.path.join(work, "ck.npz")], scan8)):
            out = os.path.join(work, f"{label}.png")
            t0 = time.time()
            proc = subprocess.run(base + extra + ["--out", out], cwd=root,
                                  env=env, capture_output=True, text=True,
                                  timeout=600)
            wall = time.time() - t0
            if proc.returncode:
                raise AssertionError(f"cli {label}: {proc.stderr[-3000:]}")
            line = json.loads(proc.stderr.strip().splitlines()[-1])
            png = read_png(out)
            diff = np.abs(png.astype(np.int32) - want.astype(np.int32))
            off = float((diff > 0).mean())
            b = line["bounces"]
            want_launches = {"B2": b, "B3": b, **(
                {"film_sum": b} if label == "regen" else {})}
            if (png.shape != want.shape or diff.any()
                    or line["nan_pixels"] or line["bounce"] != "B2"
                    or line["walk"] != "B3" or not b
                    or line["launches"] != want_launches):
                raise AssertionError(f"cli {label}: {off} of the 8-bit "
                                     f"values off (max {diff.max()}), "
                                     f"{line}")
            log(f"[cli] {label}: {wall:.1f} s in the subprocess, PNG equal "
                f"to the in-process render to the bit; {json.dumps(line)}")
            records.append({"name": f"cli {label} cornell_boxes",
                            "launches": line["launches"],
                            "wall_s": line["wall_s"],
                            "process_s": round(wall, 3)})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    return records


def scan_train_state(scene, flags, tables, spec, cam, dev,
                     bounces: int = 3) -> dict:
    """The scan train step's wavefront of all 262,144 rays (256x256, 4
    spp, the step's camera rays for seed 1) after ``bounces`` B2 bounces,
    as the step saves it for B5."""
    import torch

    from srt_tpu_torch.diff.inverse import camera_rays
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.render.integrator import initial_state

    w, spp = TRAIN["width"], TRAIN["spp"]
    rays, salt = camera_rays(cam, torch.arange(w * w, device=dev), spp,
                             width=w, height=w, seed=1)
    st = initial_state(rays, salt)
    with torch.no_grad():
        for _ in range(bounces):
            st = kb.bounce_fwd(scene, flags, tables, st, spec)
    return {k: v.contiguous() for k, v in st.items()}


def scan_train_kernels(scene, cam, dev, bounces: int = 3) -> dict:
    """B2 and B5 against their plain versions at the scan train step's
    shape (:func:`scan_train_state`); B5's time per launch beside its
    bound."""
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.kernels.build import launch
    from srt_tpu_torch.scene.ir import SceneFlags

    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=TRAIN["max_depth"])
    st = scan_train_state(scene, flags, tables, spec, cam, dev, bounces)
    with torch.no_grad():
        b2 = check_b2("scan-train", scene, flags, tables, st, spec)
        alive_after = kb.bounce_step_ref(scene, flags, tables["mat"], st,
                                         spec)["alive"]
    m5, ct = check_b5("scan-train", scene, flags, tables, st, spec,
                      alive_after)
    n, n_live = st["o"].shape[0], int(st["alive"].sum())
    bargs, bargs_out = kbb.bwd_args(scene, flags, tables, st, ct, spec)
    bwd_ms = [time_ms(lambda: launch("srt_bounce_bwd", bargs, dev), 50)
              for _ in range(2)]
    sweep = scene.n_spheres * OPS_SPHERE + scene.n_rects * OPS_RECT
    ms_bound, by = bound(n * (105 + 92),
                         n_live * (sweep + VJP_SHADE * OPS_SHADE))
    log(f"[scan-train-bwd] ms per launch at {n} lanes, {n_live} live: B5 "
        f"{bwd_ms}, bound {ms_bound:.6f} ({by})")
    torch.cuda.synchronize()
    del st, ct, bargs, bargs_out
    return {"b2": {k: b2[k] for k in ("max_abs_err", "ms", "bound_ms")},
            "b5": {"max_abs_err": m5["max_abs"], "ms": min(bwd_ms),
                   "bound_ms": ms_bound}}


def phase_scan_train(scene, cam, dev) -> dict:
    """Phase 29: the scan engine's train step (``make_train_step(engine=
    "scan")``) on ball_scenes at 256x256, 4 spp, depth 50, ``{"tex_color"}``,
    Adam 1e-2: B2 and B5 against their plain versions on the step's
    262,144-lane wavefront (:func:`scan_train_kernels`); one step to warm
    up, three timed, every bounce one B2 and one B5 launch, the losses
    and the gradient finite, the peak memory."""
    import numpy as np
    import torch

    w, spp, depth = TRAIN["width"], TRAIN["spp"], TRAIN["max_depth"]
    rays = w * w * spp
    kernels = scan_train_kernels(scene, cam, dev)

    def reset():
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
    step, warmup_s, (loss0, *losses), walls = train_walls(
        scene, cam, {"tex_color": scene.tex_color}, TRAIN, dev, TRAIN_STEPS,
        reset, engine="scan")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = depth * TRAIN_STEPS
    if (counts["B2"] != want or counts["B5"] != want or counts["B6"]
            or counts["B1"]):
        raise AssertionError(f"scan train: launches {counts}, want {want} "
                             f"B2 and B5")
    grad = step.params["tex_color"].grad.cpu().numpy()
    if not (np.isfinite([loss0] + losses).all() and np.isfinite(grad).all()
            and np.abs(grad).sum() > 0):
        raise AssertionError(f"scan train: losses {[loss0] + losses}")
    med = sorted(walls)[len(walls) // 2]
    log(f"[scan-train] ball_scenes {w}x{w}x{spp} depth {depth}, {depth} "
        f"bounces a step over all {rays} rays: median {rays / med:.1f} "
        f"train-step rays/s (step walls {walls} s), warm-up step "
        f"{warmup_s:.3f} s, losses {[loss0] + losses}, launches "
        f"{json.dumps(counts)}, peak memory {peak} B")
    return {"counts": counts, "peak_bytes": peak,
            "path": {"name": "scan train ball_scenes",
                     "launches": {k: v for k, v in counts.items() if v},
                     "wall_s": med, "peak_bytes": peak, **kernels}}


def phase_a7(dev) -> dict:
    """Phase 30: the rest of the render gate on the card at :data:`A7`,
    through both engines: the mesh-medium box (``tests/test_render.py:
    192-220``) and cornell_boxes with its back wall tiled into 64 rects
    (69 rects, past the kernels' 64): the bounce ``plain``, on the tiled
    Cornell the walk B3, as the metrics report; no NaN; the tiled
    Cornell's image within the image contract of cornell_boxes' own."""
    import warnings

    from _torch_scenes import (CORNELL_CAMERA, MEDIUM_CAMERA, cornell_tiled,
                               medium_room)

    from srt_tpu_torch import RenderConfig, get_scene, render, render_regen
    from srt_tpu_torch.render.camera import Camera
    from srt_tpu_torch.scene.build import SceneBuilder
    from srt_tpu_torch.utils import contract

    cfg = RenderConfig(**A7)
    mesh = medium_room(SceneBuilder(), "mesh").build(dev)
    mesh_cam = Camera.look_at(**MEDIUM_CAMERA, device=dev)
    tiled = cornell_tiled(SceneBuilder()).build(dev)
    tiled_cam = Camera.look_at(**CORNELL_CAMERA, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        boxes, boxes_cam, _ = get_scene("cornell_boxes", device=dev)
    out = {"paths": [], "counts": []}
    for engine, fn in (("scan", render), ("regen", render_regen)):
        _, mets, counts, _ = scan_runs(f"a7-mesh-medium-{engine}", fn, mesh,
                                       mesh_cam, cfg, 1)
        flushes = mets[0].bounces if engine == "regen" else 0
        if (mets[0].bounce, mets[0].walk) != ("plain", None) or any(
                v for k, v in counts.items() if k != "film_sum") \
                or counts["film_sum"] != flushes:
            raise AssertionError(f"mesh medium {engine}: {mets[0]}, "
                                 f"{counts}")
        out["paths"].append(path_record(f"{engine} mesh medium", counts,
                                        mets))
        imgs, mets, counts, _ = scan_runs(f"a7-tiled-cornell-{engine}", fn,
                                          tiled, tiled_cam, cfg, 1)
        if ((mets[0].bounce, mets[0].walk) != ("plain", "B3")
                or counts["B3"] != mets[0].bounces or counts["B2"]
                or counts["B1"]):
            raise AssertionError(f"tiled cornell {engine}: {mets[0]}, "
                                 f"{counts}")
        ref = fn(boxes, boxes_cam, cfg)
        m = contract.check_image(imgs[0].cpu().numpy(), ref.cpu().numpy())
        log(f"[a7-tiled-cornell-{engine}] against cornell_boxes' own "
            f"({tiled.n_rects} rects against {boxes.n_rects}): "
            f"{json.dumps(m)}")
        out["paths"].append(path_record(f"{engine} tiled cornell", counts,
                                        mets))
        out["counts"].append(counts)
    return out


# --- phases 31-34: the last modules (A13, A12, A8, A11) ----------------
#: phases 32-33: seeded blobs standing in for the scanned meshes, written
#: as PLY files (``tests/_torch_scenes.py:write_blob_ply``): the bunny's
#: size (70,200 triangles; the Stanford bunny has 69,451) and a dragon of
#: 100,000
BUNNY_MESH = dict(n_lat=151, n_lon=234, seed=0)
DRAGON_MESH = dict(n_lat=201, n_lon=250, seed=1, radius=0.09)
MERL_SEED = 3
LOOKUP_LANES = 1 << 20      # phase 32: directions of the lookup check
DIST_TIMEOUT = 600          # phase 34: seconds a process may take


def dist_train_worker(rank: int, init: str, out: str) -> None:
    """Phase 34: rank ``rank`` of two gloo processes on the one card, each
    building ball_scenes and taking the sharded ``{"tex_color"}`` step at
    phase 6's settings on its half of the pixels; rank 1 starts from other
    colours, which rank 0's replace. Saves the loss, the parameters, the
    step's launches and its wall under ``out``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from srt_tpu_torch import get_scene, make_train_step
    from srt_tpu_torch.dist import make_mesh

    dist.init_process_group("gloo", init_method=init, world_size=2,
                            rank=rank)
    try:
        mesh = make_mesh()
        scene, cam, _ = get_scene("ball_scenes", device=mesh.device)
        if rank:
            scene.tex_color.mul_(0.5)
        w = TRAIN["width"]
        step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                               width=w, height=w, spp=TRAIN["spp"],
                               max_depth=TRAIN["max_depth"], lr=TRAIN_LR,
                               engine_kw=TRAIN_ENGINE, mesh=mesh)
        target = torch.full((w, w, 3), TRAIN_TARGET, device=mesh.device)
        reset_counts()
        t0 = time.time()
        loss = float(step(target, 0))
        torch.cuda.synchronize()
        wall = time.time() - t0
        np.savez(os.path.join(out, f"rank{rank}.npz"), loss=loss, wall=wall,
                 tex_color=step.params["tex_color"].detach().cpu().numpy(),
                 counts=json.dumps(read_counts()))
    finally:
        dist.destroy_process_group()


def phase_atlas(dev) -> dict:
    """Phase 31 (A13): earth_sphere with its atlas spliced to float (its
    values are u8/255, so they are the packed twin's): B1 on phase 17's
    wavefront, B2 and B5 on phase 19's train state, each equal to the bit
    to the packed atlas's launch, and B2 on the float atlas against its
    plain version; the render path (``render_regen`` at the main path's
    settings, B1 rich) and the scan engine's image, equal to the bit to
    the packed scene's; a ``{"tex_color"}`` step on the float atlas (B2
    and B5 rich) and the ``{"atlas"}`` step at the train cell's settings
    (B2 forward, the hybrid backward with B6): finite losses, a finite
    atlas gradient, nonzero on the texels the camera sees."""
    import numpy as np
    import torch

    from srt_tpu_torch import RenderConfig, render, render_regen
    from srt_tpu_torch.core.sobol import sobol_points
    from srt_tpu_torch.diff import splice
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.render.regen_scan import steps_for
    from srt_tpu_torch.scene.ir import SceneFlags

    packed, cam = rich_scene("earth_sphere", dev)
    flt = splice(packed, {"atlas": packed.atlas})
    flags = SceneFlags.of(packed)
    if flt.atlas_u32 is not None or SceneFlags.of(flt) != flags:
        raise AssertionError("splice kept the packed atlas or moved flags")
    spec = kb.RegenSpec(width=512, height=512, spp=16, max_depth=50,
                        rr_start=1 << 30, pdf_floor=1e-9, seed=0)
    jitter = torch.from_numpy(sobol_points(16, 2).astype(np.float32))
    inp_p = kb.RegenInputs(packed, flags, cam, jitter)
    inp_f = kb.RegenInputs(flt, flags, cam, jitter)
    if inp_p.fields["atlas_f32"] or not inp_f.fields["atlas_f32"]:
        raise AssertionError("the atlas tables' kinds are wrong")
    row = dict(RICH_CASES)["earth_sphere"]
    mid = b1_wavefront(inp_p, spec, dev, row * spec.width * spec.spp)
    st_p, st_f = clone(mid), clone(mid)
    kb.regen_bounce(inp_p, st_p, spec)
    kb.regen_bounce(inp_f, st_f, spec)
    torch.cuda.synchronize()
    bad = [k for k in st_p if not same_bits(st_p[k], st_f[k])]
    if bad:
        raise AssertionError(f"B1 float atlas: {bad} differ from packed")
    b1_ms = {k: min(b1_launch_ms(inp, mid, spec, 50) for _ in range(2))
             for k, inp in (("packed", inp_p), ("float", inp_f))}

    step = kb.StepSpec(max_depth=TRAIN["max_depth"])
    tab_p = kb.build_tables(packed, flags)
    tab_f = kb.build_tables(flt, flags)
    st = train_state(packed, cam, flags, tab_p, step, dev)
    out_p = kb.bounce_fwd(packed, flags, tab_p, st, step)
    out_f = kb.bounce_fwd(flt, flags, tab_f, st, step)
    r = np.random.default_rng(5)
    ct = {k: torch.from_numpy(r.standard_normal((TRAIN_LANES, 3))
                              .astype(np.float32)).to(dev)
          for k in kbb.ROWS}
    for k in ("o", "d", "beta"):
        ct[k][~out_p["alive"]] = 0.0
    g_p, gm_p, w_p = kbb.lane_cotangents(packed, flags, tab_p, st, ct, step)
    g_f, gm_f, w_f = kbb.lane_cotangents(flt, flags, tab_f, st, ct, step)
    torch.cuda.synchronize()
    bad = [k for k in out_p if not same_bits(out_p[k], out_f[k])]
    bad += [f"d_{k}" for k in kbb.ROWS if not same_bits(g_p[k], g_f[k])]
    if not (same_bits(gm_p, gm_f) and torch.equal(w_p, w_f)):
        bad.append("material cotangents")
    if bad:
        raise AssertionError(f"B2/B5 float atlas: {bad} differ from packed")
    b2 = check_b2("atlas-float-train", flt, flags, tab_f, st, step)
    log(f"[atlas] earth_sphere atlas {packed.atlas.shape[0]} floats "
        f"({flt.atlas.shape[0] // 3} texels): B1 ({LANES} lanes, row {row}), "
        f"B2 and B5 ({TRAIN_LANES} lanes) on the float atlas equal to the "
        f"packed atlas's to the bit; B1 ms per bare launch {b1_ms}")

    cfg = RenderConfig(**MAIN)
    imgs, mets, counts, _ = scan_runs("atlas-render-float", render_regen,
                                      flt, cam, cfg, 1)
    if counts["B1"] != mets[0].bounces or counts["B2"] or mets[0].bounce != \
            "B1":
        raise AssertionError(f"atlas render: {counts}, {mets[0].bounce}")
    paths = [path_record("regen earth_sphere float atlas", counts, mets)]
    scan_cfg = RenderConfig(**SCAN)
    if not same_bits(render(flt, cam, scan_cfg), render(packed, cam,
                                                        scan_cfg)):
        raise AssertionError("the float atlas's scan image differs from the "
                             "packed atlas's")
    b1_launches = counts["B1"]

    w, spp = TRAIN["width"], TRAIN["spp"]
    n_steps = steps_for(w * w * spp, TRAIN_ENGINE["wavefront"],
                        TRAIN_ENGINE["depth_budget"], TRAIN["max_depth"],
                        drain=TRAIN_ENGINE["drain"])
    totals = {"B1": b1_launches, "B2": 0, "B5": 0, "B6": 0,
              "segment_sum": 0}
    for label, scene, params, want in (
            ("tex_color float atlas", flt, {"tex_color": flt.tex_color},
             ("B2", "B5", "segment_sum")),
            ("atlas", packed, {"atlas": packed.atlas}, ("B2", "B6"))):
        stp, warm, losses, walls = train_walls(scene, cam, params, TRAIN,
                                               dev, 1, reset_counts)
        counts = read_counts()
        if any(counts[k] != (n_steps if k in want else 0) for k in counts):
            raise AssertionError(f"{label} step: {counts} for {n_steps} "
                                 "bounces")
        for k in want:
            totals[k] += counts[k]
        g = next(iter(stp.params.values())).grad
        if not (np.isfinite(losses).all() and torch.isfinite(g).all()):
            raise AssertionError(f"{label} step: losses {losses}")
        nonzero = int((g.reshape(-1, 3).abs().sum(1) > 0).sum())
        if not nonzero:
            raise AssertionError(f"{label} step: a zero gradient")
        paths.append({"name": f"train {label}", "launches": {
            k: v for k, v in counts.items() if v}, "wall_s": walls[0]})
        log(f"[atlas-train] {label}: {w}x{w}x{spp} depth "
            f"{TRAIN['max_depth']}, {n_steps} bounces: step wall "
            f"{walls[0]:.3f} s ({w * w * spp / walls[0]:.1f} train-step "
            f"rays/s), warm-up {warm:.3f} s, losses {losses}, launches "
            f"{json.dumps(counts)}, gradient finite, {nonzero} of "
            f"{g.reshape(-1, 3).shape[0]} rows nonzero")
    return {"b2": b2, "paths": paths, "counts": totals}


def merl_scene(dev, mesh_path: str, table):
    """``cornell_box``'s layout (``srt_tpu/scene/library.py:264-294``: an
    Oren–Nayar floor, the rect light, the sky dome as its stand-in) with
    the mesh at ``mesh_path`` placed as the bunny is, in a MERL material of
    ``table``. Returns the scene and the camera."""
    import numpy as np

    from srt_tpu_torch.io.mesh import load_mesh
    from srt_tpu_torch.render.camera import Camera
    from srt_tpu_torch.scene.build import SceneBuilder, rotation_y

    lookfrom = (300.0, 500.0, -800.0)
    b = SceneBuilder()
    light = b.diffuse_light(b.constant((45.0, 45.0, 45.0)))
    floor = b.oren_nayar(b.constant((0.7, 0.7, 0.7)), 0.0)
    measured = b.merl(table, (1.0, 1.0, 1.0))
    lid = b.xz_rect(203, 353, 217, 343, 800, light, flip=True)
    b.xz_rect(0, 555, 0, 555, 0, floor)
    sky = np.full((8, 8, 3), (153, 178, 229), np.uint8)
    b.sphere(lookfrom, 10000.0, b.diffuse_light(b.image(sky)), flip=True)
    b.trimesh(load_mesh(mesh_path), measured, scale=2000.0,
              rotate=rotation_y(180.0), translate=(250, -70, 400),
              flip_winding=True)
    b.light_rect(lid)
    return b.build(dev), Camera.look_at(
        lookfrom, (300, 278, 200), vfov=40.0, aspect=1.0, aperture=0.0,
        focus_dist=10.0, device=dev)


def phase_merl(dev) -> dict:
    """Phase 32 (A12): a seeded smooth MERL table written with
    ``write_merl`` and read back with ``read_merl`` (17.5 MB), on a
    70,200-triangle blob loaded by ``load_mesh`` from a PLY the phase
    writes, in ``cornell_box``'s layout; ``lookup`` on the card against
    its CPU run on 2^20 seeded direction pairs (indices within
    ``contract.MERL_INDEX_MISMATCH``, values equal where they agree); the
    render at the main path's settings through both engines, the route
    the walk B3 and the plain bounce, no NaN."""
    import tempfile

    import numpy as np
    import torch
    from _torch_scenes import merl_table, write_blob_ply

    from srt_tpu_torch import RenderConfig, render, render_regen
    from srt_tpu_torch.io.merl import read_merl, write_merl
    from srt_tpu_torch.materials import merl
    from srt_tpu_torch.utils import contract

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        write_merl(os.path.join(tmp, "smooth.binary"), merl_table(MERL_SEED))
        table = read_merl(os.path.join(tmp, "smooth.binary"))
        io_s = time.time() - t0
        n_tris = write_blob_ply(os.path.join(tmp, "blob.ply"), **BUNNY_MESH)
        scene, cam = merl_scene(dev, os.path.join(tmp, "blob.ply"), table)
    r = np.random.default_rng(7)
    dirs = r.standard_normal((2, LOOKUP_LANES, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs[..., 2] = np.abs(dirs[..., 2])
    wo, wi = (torch.from_numpy(x) for x in dirs)
    tid = torch.zeros(LOOKUP_LANES, dtype=torch.int32)
    idx_c = merl.half_diff_indices(wo, wi)
    idx_g = merl.half_diff_indices(wo.to(dev), wi.to(dev)).cpu()
    f_c = merl.lookup(scene.merl.cpu(), tid, wo, wi)
    f_g = merl.lookup(scene.merl, tid.to(dev), wo.to(dev), wi.to(dev)).cpu()
    same = idx_c == idx_g
    share = float((~same).float().mean())
    if share > contract.MERL_INDEX_MISMATCH or not torch.equal(
            f_c[same], f_g[same]):
        raise AssertionError(f"MERL lookup: {share} of indices differ, or "
                             "values at equal indices")
    log(f"[merl] table {tuple(table.shape)} ({table.nbytes} B) written and "
        f"read in {io_s:.3f} s; mesh {n_tris} triangles; lookup on "
        f"{LOOKUP_LANES} direction pairs: {int((~same).sum())} indices "
        f"differ from the CPU's (share {share}, limit "
        f"{contract.MERL_INDEX_MISMATCH}), values equal where they agree")
    cfg = RenderConfig(**SCAN)
    paths, counts_all = [], []
    for engine, fn in (("scan", render), ("regen", render_regen)):
        _, mets, counts, _ = scan_runs(f"merl-{engine}", fn, scene, cam, cfg,
                                       1)
        if ((mets[0].bounce, mets[0].walk) != ("plain", "B3")
                or counts["B3"] != mets[0].bounces or counts["B2"]
                or counts["B1"]):
            raise AssertionError(f"merl {engine}: {mets[0]}, {counts}")
        paths.append(path_record(f"{engine} merl", counts, mets))
        counts_all.append(counts)
    return {"paths": paths, "B3": sum(c["B3"] for c in counts_all)}


def phase_mesh_scenes(dev) -> dict:
    """Phase 33 (A8): a binary PLY of 70,200 triangles (the Stanford
    bunny's size) and a 100,000-triangle dragon, written as
    ``models/bunny.ply`` and ``models/dragon.ply`` under a temporary
    ``SRT_ASSETS`` root; ``cornell_box`` with its bunny (the host's load
    and build seconds), B3 against the plain walk on a 65,536-lane
    wavefront of its render, the render at the main path's settings (one
    B3 and one B2 a bounce); ``teapot_scene`` at divs=100 with the bunny
    and the dragon, B4 against its plain walk on its bounced wavefront,
    and its render (one B4 and one B2 a bounce)."""
    import tempfile
    import warnings

    import torch
    from _torch_scenes import write_blob_ply

    from srt_tpu_torch import RenderConfig, get_scene, render_regen
    from srt_tpu_torch.kernels import intersect as ki

    cfg = RenderConfig(**MAIN)
    out = {"paths": []}
    old = os.environ.get("SRT_ASSETS")
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "models"))
        n_bunny = write_blob_ply(os.path.join(tmp, "models", "bunny.ply"),
                                 **BUNNY_MESH)
        n_dragon = write_blob_ply(os.path.join(tmp, "models", "dragon.ply"),
                                  **DRAGON_MESH)
        os.environ["SRT_ASSETS"] = tmp
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                t0 = time.time()
                box, box_cam, info = get_scene("cornell_box", device=dev)
                box_s = time.time() - t0
                t0 = time.time()
                pot, pot_cam, pot_info = get_scene(
                    "teapot_scene", device=dev, divs=TEAPOT_DIVS)
                pot_s = time.time() - t0
        finally:
            if old is None:
                del os.environ["SRT_ASSETS"]
            else:
                os.environ["SRT_ASSETS"] = old
    if "models/bunny.ply" in info.get("skipped", []) or box.n_tris != n_bunny:
        raise AssertionError(f"cornell_box: {box.n_tris} triangles, "
                             f"skipped {info.get('skipped')}")
    if pot.n_tris <= n_bunny + n_dragon or any(
            m in pot_info.get("skipped", []) for m in
            ("models/bunny.ply", "models/dragon.ply")):
        raise AssertionError(f"teapot_scene: {pot.n_tris} triangles, "
                             f"skipped {pot_info.get('skipped')}")
    log(f"[meshes] cornell_box: {box.n_tris} triangles, get_scene "
        f"{box_s:.3f} s (PLY read {info['mesh_s']:.3f} s); teapot_scene: "
        f"{pot.n_tris} triangles ({n_bunny} bunny, {n_dragon} dragon), "
        f"get_scene {pot_s:.3f} s (PLY reads {pot_info['mesh_s']:.3f} s), "
        f"host seconds {json.dumps(pot_info['host_s'])}")
    st = step_wavefront(box, box_cam, dev)[0]
    out["b3"] = check_tri_kernel("cornell_box-bunny", box, st["o"], st["d"])
    del st
    _, mets, counts, _ = scan_runs("cornell_box-bunny", render_regen, box,
                                   box_cam, cfg, 1)
    if ((mets[0].bounce, mets[0].walk) != ("B2", "B3")
            or not counts["B3"] == mets[0].bounces == counts["B2"]):
        raise AssertionError(f"cornell_box: {mets[0]}, {counts}")
    out["paths"].append(path_record("regen cornell_box bunny", counts, mets))
    out["B3"], out["B2"] = counts["B3"], counts["B2"]
    del box
    st = step_wavefront(pot, pot_cam, dev, row=TEAPOT_ROW)[0]
    out["b4"] = check_big_kernel("teapot-meshes", pot, ki.pack_big_tables(
        pot), ki.pack_tables(pot), st["o"], st["d"])
    del st
    _, mets, counts, _ = scan_runs("teapot-meshes", render_regen, pot,
                                   pot_cam, cfg, 1)
    if ((mets[0].bounce, mets[0].walk) != ("B2", "B4")
            or not counts["B4"] == mets[0].bounces == counts["B2"]
            or counts["B3"]):
        raise AssertionError(f"teapot_scene: {mets[0]}, {counts}")
    out["paths"].append(path_record("regen teapot bunny dragon", counts,
                                    mets))
    out["B4"] = counts["B4"]
    out["B2"] += counts["B2"]
    torch.cuda.synchronize()
    return out


def phase_dist(root: str, scene, cam, dev) -> dict:
    """Phase 34 (A11): ``render_sharded`` on a one-process NCCL group
    against ``render`` at the scan engine's settings on ball_scenes (to
    the bit); whether a gloo group takes the card's tensors in
    ``all_gather``; the sharded train step on that group against the
    unsharded one (at world size 1 no collective runs); the sharded step
    of two gloo processes on the one card, whose ``all_reduce`` of the
    loss and gradients runs on the card's tensors, against the unsharded
    one (loss within 1e-6, parameters within 1e-5, JAX's
    ``tests/test_dist.py`` bounds); then ``python -m
    srt_tpu_torch.dist.multihost`` as two gloo processes on the one card
    and as one process, the linear images equal to the bit. Every group
    meets through a file in a fresh temporary directory, so no TCP port
    is taken. No scaling is measured: both processes share one card."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from srt_tpu_torch import RenderConfig, make_train_step, render
    from srt_tpu_torch.dist import make_mesh, render_sharded

    cfg = RenderConfig(**SCAN)
    out = {"paths": []}
    tmp = tempfile.mkdtemp(prefix="srt_dist_")
    dist.init_process_group("nccl", init_method="file://"
                            + os.path.join(tmp, "nccl"), world_size=1, rank=0)
    try:
        mesh = make_mesh()
        reset_counts()
        t0 = time.time()
        img_s = render_sharded(scene, cam, cfg, mesh)
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        counts = read_counts()
        t0 = time.time()
        img_r = render(scene, cam, cfg)
        torch.cuda.synchronize()
        wall_r = time.time() - t0
        if not same_bits(img_s, img_r):
            raise AssertionError("render_sharded differs from render")
        if counts["B2"] != scan_chunks(cfg) * cfg.max_depth:
            raise AssertionError(f"render_sharded launches {counts}")
        out["paths"].append({"name": "render_sharded nccl 1", "launches": {
            k: v for k, v in counts.items() if v}, "wall_s": wall_s})
        out["B2"] = counts["B2"]
        gloo = dist.new_group(backend="gloo")
        x = torch.arange(4.0, device=dev)
        parts = [torch.empty_like(x)]
        try:
            dist.all_gather(parts, x, group=gloo)
            gloo_cuda = bool(torch.equal(parts[0], x))
        except RuntimeError as e:
            gloo_cuda = f"refused: {str(e).splitlines()[0][:160]}"
        w = TRAIN["width"]
        target = torch.full((w, w, 3), TRAIN_TARGET, device=dev)
        steps = [make_train_step(scene, cam, {"tex_color": scene.tex_color},
                                 width=w, height=w, spp=TRAIN["spp"],
                                 max_depth=TRAIN["max_depth"], lr=TRAIN_LR,
                                 engine_kw=TRAIN_ENGINE, device=dev,
                                 mesh=m) for m in (None, mesh)]
        losses, walls = [], []
        for stp in steps:
            t0 = time.time()
            losses.append(float(stp(target, 0)))
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        dp = float((steps[0].params["tex_color"]
                    - steps[1].params["tex_color"]).detach().abs().max())
        if abs(losses[0] - losses[1]) > 1e-6 or dp > 1e-5:
            raise AssertionError(f"sharded step: losses {losses}, params "
                                 f"max |d| {dp}")
    finally:
        dist.destroy_process_group()
    log(f"[dist] nccl world 1: render_sharded {wall_s:.3f} s, render "
        f"{wall_r:.3f} s, equal to the bit, launches {json.dumps(counts)}; "
        f"gloo all_gather of the card's tensors: {gloo_cuda}; sharded train "
        f"step (no collective at world size 1) {walls[1]:.3f} s against "
        f"{walls[0]:.3f} s, losses {losses}, params max |d| {dp}")

    t0 = time.time()
    ctx = mp.start_processes(dist_train_worker, nprocs=2, join=False,
                             args=("file://" + os.path.join(tmp, "train"),
                                   tmp), start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.time() - t0 > DIST_TIMEOUT:
                raise AssertionError(f"sharded train step: two processes "
                                     f"still running after {DIST_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    wall_two = time.time() - t0
    ranks = [np.load(os.path.join(tmp, f"rank{r}.npz")) for r in (0, 1)]
    want = steps[0].params["tex_color"].detach().cpu().numpy()
    dl = abs(float(ranks[0]["loss"]) - losses[0])
    dp2 = float(np.abs(ranks[0]["tex_color"] - want).max())
    if (dl > 1e-6 or dp2 > 1e-5
            or not np.array_equal(ranks[0]["tex_color"],
                                  ranks[1]["tex_color"])):
        raise AssertionError(f"two-process sharded step: loss "
                             f"{float(ranks[0]['loss'])} against {losses[0]}"
                             f", params max |d| {dp2}, ranks equal "
                             f"{np.array_equal(*(r['tex_color'] for r in ranks))}")
    step_counts = json.loads(str(ranks[0]["counts"]))
    if not step_counts["B2"] or not step_counts["B5"]:
        raise AssertionError(f"two-process sharded step: launches "
                             f"{step_counts}")
    step_walls = [float(r["wall"]) for r in ranks]
    log(f"[dist] sharded train step, two gloo processes on one card "
        f"(all_reduce of the card's loss and gradients): step "
        f"{step_walls[0]:.3f} s and {step_walls[1]:.3f} s against the "
        f"unsharded {walls[0]:.3f} s, {wall_two:.1f} s from process start; "
        f"loss |d| {dl}, params max |d| {dp2}, the ranks equal; rank 0's "
        f"launches {json.dumps(step_counts)}")
    out["paths"].append({"name": "sharded train step gloo 2 processes",
                         "launches": {k: v for k, v in step_counts.items()
                                      if v}, "wall_s": step_walls[0]})
    shutil.rmtree(tmp, ignore_errors=True)

    env = dict(os.environ, PYTHONPATH=root)
    base = [sys.executable, "-m", "srt_tpu_torch.dist.multihost", "--scene",
            "ball_scenes", "--width", str(MAIN["width"]), "--spp",
            str(MAIN["spp"]), "--max-depth", str(MAIN["max_depth"]),
            "--device", str(dev)]
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        t0 = time.time()
        procs = [subprocess.Popen(
            base + ["--num-processes", "2", "--process-id", str(i),
                    "--coordinator", "file://" + os.path.join(tmp, "pg"),
                    "--backend", "gloo",
                    "--out", os.path.join(tmp, "two.npy")],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(2)]
        try:
            logs = [p.communicate(timeout=DIST_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        runs["two"] = time.time() - t0
        if any(p.returncode for p in procs):
            raise AssertionError(f"multihost, two processes: "
                                 f"{[p.returncode for p in procs]} "
                                 f"{[lg[-2000:] for lg in logs]}")
        t0 = time.time()
        one = subprocess.run(base + ["--out", os.path.join(tmp, "one.npy")],
                             cwd=root, env=env, capture_output=True,
                             text=True, timeout=DIST_TIMEOUT)
        runs["one"] = time.time() - t0
        if one.returncode:
            raise AssertionError(f"multihost, one process: {one.stderr[-2000:]}")
        a = np.load(os.path.join(tmp, "two.npy"))
        b = np.load(os.path.join(tmp, "one.npy"))
    if a.shape != b.shape or not np.array_equal(a.view(np.int32),
                                                b.view(np.int32)):
        raise AssertionError("multihost: two processes' image differs from "
                             "one process's")
    if not np.array_equal(b, img_r.cpu().numpy()):
        raise AssertionError("multihost: one process's image differs from "
                             "render's")
    log(f"[dist] python -m srt_tpu_torch.dist.multihost on ball_scenes "
        f"{MAIN['width']}x{MAIN['width']}x{MAIN['spp']} depth "
        f"{MAIN['max_depth']}: two gloo processes on one card "
        f"{runs['two']:.1f} s, one process {runs['one']:.1f} s (each wall "
        f"from process start: interpreter, library load, scene, render), "
        f"the images equal to the bit and to render's; "
        f"{logs[0].strip().splitlines()[-1]}")
    out["paths"].append({"name": "multihost gloo 2 processes",
                         "launches": {}, "wall_s": runs["two"]})
    out["paths"].append({"name": "multihost 1 process", "launches": {},
                         "wall_s": runs["one"]})
    return out


# --- phases 35-37: the sphere BVH and the tools (A15, A16) -------------
#: phase 35: a seeded field of spheres (``tests/_torch_scenes.py:
#: sphere_field``) past the bounce kernels' gate of 4,096, so both engines
#: take the plain bounce; the reference's many-sphere scenes stand behind
#: it (random_scene's ground, lights and camera)
FIELD_SPHERES = 10_000
FIELD = dict(MAIN)
#: phase 35 (b): both renders (the switch on and off) at this size, the
#: main path's unless the phase's budget forces a cut, which is printed.
#: Cut to 8 spp: at 16 the walk's render took 49 s and the sweep's 25 s,
#: and the phase 95 s of its 90
FIELD_RENDER = dict(width=512, height=512, spp=8)
FIELD_ROW = 192             # phase 35 (a): camera rays of rows 192-319
#: phase 35 (a) also at a larger field, where the sweep's cost (linear in
#: the spheres) meets the walk's: the intersections only, no render
FIELD_MORE = 40_000
FIELD_BUDGET_S = 90
FIELD_REPS = 3              # timed intersections at each input
SPHERE_T_ATOL = 2e-5        # JAX's own bounds (tests/test_intersect.py)
SPHERE_N_ATOL = 2e-4
#: phases 36-37
SCALING_BUDGET_S = 120
TOOLS_BUDGET_S = 120
TOOLS_CHUNK = dict(size=512, spp=8)   # golden_avg's two parity chunks


def field_hits(label: str, scene, flags, o, d, time_) -> dict:
    """Phase 35 (a): the sphere BVH's walk (``intersect_scene`` with the
    switch) against the sweep on rays ``o, d``: hit and material equal,
    ``t`` within :data:`SPHERE_T_ATOL` and the normal within
    :data:`SPHERE_N_ATOL` on the hits, the walk's winner the sweep's on
    every ray (the field has no dome); the longest walk's visits and each
    one's ms per call."""
    import torch

    from srt_tpu_torch.render.intersect import (intersect_scene,
                                                sphere_bvh_winner,
                                                sphere_winner)

    def walk():
        return intersect_scene(scene, o, d, 1e-3, time=time_,
                               sphere_bvh=True, sbvh_leaf=flags.sbvh_leaf)

    def sweep():
        return intersect_scene(scene, o, d, 1e-3, time=time_)

    with torch.no_grad():
        hw, hs = walk(), sweep()
        k, visits = sphere_bvh_winner(scene, o, d, time_, 1e-3,
                                      flags.sbvh_leaf, stats=True)
        _, k_sweep = sphere_winner(scene, o, d, time_)
        both = hw.hit & hs.hit
        dt = float((hw.t - hs.t)[both].abs().max()) if both.any() else 0.0
        dn = (float((hw.normal - hs.normal)[both].abs().max())
              if both.any() else 0.0)
        if (not torch.equal(hw.hit, hs.hit)
                or not torch.equal(hw.mat[both], hs.mat[both])
                or dt > SPHERE_T_ATOL or dn > SPHERE_N_ATOL
                or not torch.equal(k, k_sweep)):
            raise AssertionError(
                f"{label}: the walk against the sweep: hits "
                f"{int(hw.hit.sum())}/{int(hs.hit.sum())}, |dt| {dt}, "
                f"|dn| {dn}, winners differ on "
                f"{int((k != k_sweep).sum())}")
        out = {"rays": o.shape[0], "hits": int(hw.hit.sum()),
               "max_abs_dt": dt, "max_abs_dn": dn,
               "visits_max": int(visits.max()),
               "visits_mean": float(visits.float().mean()),
               "walk_ms": time_ms(walk, FIELD_REPS),
               "sweep_ms": time_ms(sweep, FIELD_REPS)}
    log(f"[sphere-bvh-{label}] {json.dumps(out)}")
    return out


def phase_sphere_bvh(dev) -> dict:
    """Phase 35 (A15): the sphere BVH on the card. The field of
    :data:`FIELD_SPHERES` spheres, its tree built by the native builder;
    (a) the walk against the sweep (:func:`field_hits`) on 65,536 camera
    rays (rows 192-319 of a 512x512 image) and on the same rays after two
    plain bounces, and the same on a field of :data:`FIELD_MORE`; (b) ``render_regen`` at :data:`FIELD` with
    ``sphere_bvh`` on and off (both at :data:`FIELD_RENDER`): the bounce
    plain, no kernel launched, no
    NaN, the two images within the image contract. Budget
    :data:`FIELD_BUDGET_S` s; the cuts and the walls are printed."""
    import dataclasses

    import numpy as np
    import torch
    from _torch_scenes import SPHERE_FIELD_CAMERA, sphere_field

    from srt_tpu_torch import RenderConfig, render_regen
    from srt_tpu_torch.render.api import chunk_rays, pixel_jitter
    from srt_tpu_torch.render.camera import Camera
    from srt_tpu_torch.render.integrator import bounce_step
    from srt_tpu_torch.scene.build import SceneBuilder
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    t_phase = time.time()
    b = sphere_field(SceneBuilder(), FIELD_SPHERES)
    scene = b.build(dev)
    cam = Camera.look_at(**SPHERE_FIELD_CAMERA, device=dev)
    flags = SceneFlags.of(scene)
    if flags.fused_bounce or scene.sbvh_ids is None:
        raise AssertionError(f"sphere field: fused {flags.fused_bounce}, "
                             f"tree {scene.sbvh_ids is not None}")
    log(f"[sphere-bvh] {scene.n_spheres} spheres, {scene.n_rects} rects, "
        f"tree of {scene.sbvh_skip.shape[0]} nodes, widest leaf "
        f"{flags.sbvh_leaf}; host build {json.dumps(b.seconds)}")

    cfg = RenderConfig(**FIELD)
    w = FIELD["width"]
    pix = torch.arange(LANES, device=dev) + FIELD_ROW * w
    jitter = pixel_jitter(cfg).to(dev)

    def both_inputs(label: str, scene, flags) -> dict:
        """:func:`field_hits` on the camera rays and on the same rays
        after two plain bounces."""
        (o, d, tm), salt = chunk_rays(cam, pix, 0, jitter, 0, width=w,
                                      height=FIELD["height"], n_samples=1)
        res = {"camera": field_hits(f"{label}-camera", scene, flags, o, d,
                                    tm)}
        st = dict(o=o, d=d, time=tm, beta=torch.ones_like(o),
                  radiance=torch.zeros_like(o), salt=salt.to(torch.int32),
                  depth=torch.zeros((LANES,), dtype=torch.int32, device=dev),
                  alive=torch.ones((LANES,), dtype=torch.bool, device=dev))
        with torch.no_grad():
            for _ in range(2):
                st = bounce_step(scene, st, FIELD["max_depth"], 1 << 30,
                                 flags)
        res["bounced"] = field_hits(f"{label}-bounced", scene, flags,
                                    st["o"], st["d"], st["time"])
        res["bounced"]["alive"] = int(st["alive"].sum())
        return res

    out = both_inputs(str(FIELD_SPHERES), scene, flags)
    more = sphere_field(SceneBuilder(), FIELD_MORE).build(dev)
    out["more"] = both_inputs(str(FIELD_MORE), more, SceneFlags.of(more))
    del more

    walls, imgs, paths = {}, {}, []
    cut = dataclasses.replace(cfg, **FIELD_RENDER)
    for name, c in (("sphere_bvh", dataclasses.replace(
            cut, sphere_bvh=True)), ("sweep", cut)):
        torch.cuda.synchronize()
        reset_counts()
        img, m = render_regen(scene, cam, c, metrics=True)
        counts = read_counts()
        a = img.cpu().numpy()
        nan = int(np.isnan(a).sum())
        if (m.bounce, m.walk) != ("plain", None) or any(
                v for k, v in counts.items() if k != "film_sum") \
                or counts["film_sum"] != m.bounces \
                or nan or m.nan_scrubbed or not 0.0 < float(a.mean()) < 1.0:
            raise AssertionError(f"sphere field {name}: {m.to_dict()}, "
                                 f"{counts}, nan {nan}")
        walls[name], imgs[name] = m.wall_s, a
        paths.append({"name": f"regen sphere field {name} "
                              f"{c.width}x{c.height}x{c.spp}x{c.max_depth}",
                      "launches": {"film_sum": m.bounces},
                      "wall_s": m.wall_s})
        log(f"[sphere-bvh-render] {name} {c.width}x{c.height}x{c.spp} depth "
            f"{c.max_depth}: wall {m.wall_s:.3f} s, "
            f"{m.primary_rays_per_sec:.1f} primary rays/s, mean "
            f"{a.mean():.5f}, nan_pixels {nan}, bounces {m.bounces}")
    agree = contract.check_image(imgs["sphere_bvh"], imgs["sweep"])
    phase_s = time.time() - t_phase
    cuts = [f"both renders' {k} {FIELD[k]} -> {v}"
            for k, v in FIELD_RENDER.items() if v != FIELD[k]]
    log(f"[sphere-bvh] budget {FIELD_BUDGET_S} s, took {phase_s:.1f} s; "
        f"cuts: {cuts or 'none'}; walls {json.dumps(walls)}; images "
        f"{json.dumps(agree)}")
    if phase_s > 2 * FIELD_BUDGET_S:
        raise AssertionError(f"phase 35 took {phase_s:.1f} s")
    out.update(walls=walls, agree=agree, paths=paths, cuts=cuts)
    return out


def phase_scaling(root: str) -> dict:
    """Phase 36 (A16): ``python -m srt_tpu_torch.dist.scaling --devices 1
    2`` on the one card (two gloo processes share it): two processes'
    image equal to one's to the bit, ``cards`` 1, ``backend`` gloo; the
    JSON line printed. No scaling is measured: the card is shared."""
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "srt_tpu_torch.dist.scaling", "--devices",
         "1", "2", "--timeout", str(SCALING_BUDGET_S)],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=3 * SCALING_BUDGET_S)
    wall = time.time() - t0
    if proc.returncode:
        raise AssertionError(f"scaling: {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = rec["devices"]
    if (rec["cards"], rec["backend"]) != (1, "gloo") \
            or rows["2"].get("bit_exact_vs_1dev") is not True \
            or rows["1"]["efficiency_vs_linear"] != 1.0:
        raise AssertionError(f"scaling: {rec}")
    log(f"[scaling] budget {SCALING_BUDGET_S} s, took {wall:.1f} s, no "
        f"cuts: {json.dumps(rec)}")
    return {"paths": [{"name": "dist.scaling 1 and 2 processes",
                       "launches": {}, "wall_s": wall}]}


def phase_tools(root: str, dev) -> dict:
    """Phase 37 (A16): ``python -m srt_tpu_torch.phases --scene
    ball_scenes --lanes 65536 --loop 4`` in a subprocess, every number
    finite and positive; the golden tool's two parity chunks of
    ball_scenes (:data:`TOOLS_CHUNK`, seeds 1 and 2, the golden's size)
    averaged by ``golden_avg`` against ``goldens/ball_parity_4096avg.png``,
    its PSNR finite; ``regions`` at 500x500, 4 spp over the four floor variants,
    one row a variant (both in process, their launches read)."""
    import math
    import shutil
    import tempfile

    from srt_tpu_torch import golden, golden_avg, regions

    t_phase = time.time()
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-m", "srt_tpu_torch.phases", "--scene",
         "ball_scenes", "--lanes", str(LANES), "--loop", "4"],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=3 * TOOLS_BUDGET_S)
    if proc.returncode:
        raise AssertionError(f"phases: {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    nums = {k: v for k, v in {**rec, **{f"route.{k}": v for k, v in
                                        rec["route"].items()}}.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}
    bad = {k: v for k, v in nums.items() if not (math.isfinite(v) and v > 0)}
    if bad or rec["route"]["bounce"] != "B2":
        raise AssertionError(f"phases: {bad}, {rec['route']}")
    log(f"[tools-phases] {json.dumps(rec)}")

    tmp = tempfile.mkdtemp(prefix="srt_tools_")
    paths = []
    try:
        reset_counts()
        t0 = time.time()
        size, spp = TOOLS_CHUNK["size"], TOOLS_CHUNK["spp"]
        for seed in (1, 2):
            golden.run(golden.parse_args(
                ["--scene", "ball_scenes", "--size", str(size), "--spp",
                 str(spp), "--ref-parity", "--seed", str(seed),
                 "--out-dir", tmp, "--out-name", f"chunk_s{seed}.ppm",
                 "--device", str(dev)]))
        avg = golden_avg.run(golden_avg.parse_args(
            ["--chunks", os.path.join(tmp, "chunk_s*.ppm"), "--golden",
             os.path.join(root, "goldens", "ball_parity_4096avg.png")]))
        counts = read_counts()
        if avg["n_chunks"] != 2 or not math.isfinite(avg["psnr_db"]) \
                or not counts["B2 parity"]:
            raise AssertionError(f"golden_avg: {avg}, {counts}")
        paths.append({"name": f"golden parity chunks ball_scenes "
                              f"{size}x{size}x{spp} x2",
                      "launches": {k: v for k, v in counts.items() if v},
                      "wall_s": time.time() - t0})
        log(f"[tools-golden-avg] chunks {size}x{size}x{spp} parity seeds 1, "
            f"2: {json.dumps(avg)}")

        reset_counts()
        t0 = time.time()
        variants = ["ref", "nocoat", "lambert", "rect"]
        reg = regions.run(regions.parse_args(
            ["--spp", "4", "--size", "500", "--variants", *variants,
             "--out-dir", tmp, "--device", str(dev)]))
        counts = read_counts()
        if "golden" not in reg or any(v not in reg for v in variants) or \
                not all(math.isfinite(x) for v in variants
                        for k in ("floor_rgb", "sky_rgb", "soldier_rgb")
                        for x in reg[v][k]):
            raise AssertionError(f"regions: {reg}")
        paths.append({"name": "regions soldier_scene 500x500x4 4 variants",
                      "launches": {k: v for k, v in counts.items() if v},
                      "wall_s": time.time() - t0})
        log(f"[tools-regions] {json.dumps(reg)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_s = time.time() - t_phase
    log(f"[tools] budget {TOOLS_BUDGET_S} s, took {phase_s:.1f} s, no cuts")
    return {"paths": paths}


#: phase 38: the film flush recorded mid-render (the main path's 176
#: bounces: bounce 40 has finished lanes of many pixels, two bounces of
#: some)
FLUSH_AT = 40
#: phase 38: the main path's samples a pixel for the long chains: a pixel's
#: 1,024 camera rays are handed out together and leave the scene together
DEEP_SPP = 1024
#: phase 38: the material sum at the regen-scan and the scan train steps'
#: wavefronts
SUM_LANES = (TRAIN_LANES, 1 << 18)
#: phase 39: the matrix's size, cut from bench.py's 256x256x8 for the
#: script's time limit
MATRIX = dict(width=64, spp=2)
BENCH_BUDGET_S = 240


def same_tensor_bits(a, b) -> bool:
    """``a`` and ``b`` equal bit for bit, a NaN equal to any NaN (the
    card's NaN is not the CPU's)."""
    import torch
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a = a.masked_fill(nan, 0.0).view(torch.int32)
        b = b.masked_fill(nan, 0.0).view(torch.int32)
    return bool(torch.equal(a, b))


#: phase 38's seeded flushes, 70% of the lanes finished: each lane's pixel
#: by layout, and the lanes. Scattered over 1,024 pixels (about 45 lanes a
#: pixel, most in a 256-lane tile of their own: up to 66 records), over 64
#: pixels (about 700 lanes a pixel, a record in nearly each of the 256
#: tiles), in runs of 1,024 lanes a pixel (the camera rays of 1,024
#: samples, four dense records a pixel), and over 512 pixels of a
#: 262,144-lane wavefront (more tiles than a block each and than one walk
#: of a chain places)
SYNTHETIC = (("scattered-1024", LANES), ("scattered-64", LANES),
             ("runs-1024", LANES), ("scattered-512", 1 << 18))


def synthetic_flush(dev, layout: str, n: int) -> tuple:
    """A seeded flush of ``n`` lanes in :data:`SYNTHETIC`'s ``layout``,
    radiance of mixed signs and magnitudes with NaN and +-inf, on a film
    of nonzero sums: ``(acc, n_vertices, nan_scrubbed, pix, radiance, fin,
    alive)``."""
    import numpy as np
    import torch

    r = np.random.default_rng(7)
    kind, count = layout.split("-")
    pix = (r.integers(0, int(count), n) if kind == "scattered"
           else np.arange(n) // int(count)).astype(np.int32)
    rad = (r.standard_normal((3, n)) * 10.0 ** r.integers(-3, 4, (1, n))
           ).astype(np.float32)
    rad[r.random((3, n)) < 0.01] = np.nan
    rad[r.random((3, n)) < 0.005] = np.inf
    rad[r.random((3, n)) < 0.005] = -np.inf
    acc = r.standard_normal((3, int(pix.max()) + 1)).astype(np.float32)
    fin = (r.random(n) < 0.7).astype(np.int32)
    alive = (r.random(n) < 0.3).astype(np.int32)

    def t(x):
        return torch.from_numpy(x).to(dev)
    return (t(acc), torch.tensor(5, device=dev), torch.tensor(7, device=dev),
            t(pix), t(rad), t(fin), t(alive))


class _Recorded(Exception):
    """Ends a render once its flush is recorded."""


def record_flush(render, at: int) -> tuple:
    """The film and the arguments of the ``at``-th flush of ``render()``,
    copied just before that flush: ``(acc, n_vertices, nan_scrubbed, pix,
    radiance, fin, alive)``. The render stops there."""
    from srt_tpu_torch.kernels import film as kfilm

    orig = kfilm.Film.flush
    calls, rec = [0], []

    def capture(self, pix, radiance, fin, alive):
        if calls[0] == at:
            rec.append((self.acc.clone(), self.n_vertices.clone(),
                        self.nan_scrubbed.clone(), pix.clone(),
                        radiance.clone(), fin.clone(), alive.clone()))
            raise _Recorded
        calls[0] += 1
        orig(self, pix, radiance, fin, alive)
    kfilm.Film.flush = capture
    try:
        render()
    except _Recorded:
        pass
    finally:
        kfilm.Film.flush = orig
    if not rec:
        raise AssertionError(f"the render made {calls[0]} flushes, not "
                             f"{at + 1}")
    return rec[0]


def check_flush(label: str, rec: tuple, timing: bool = True) -> dict:
    """The film kernel against its plain version on a recorded flush: two
    launches from the same film, each equal to the plain version on the
    CPU (``index_add_`` lane after lane) to the bit, sums and counts, and
    the largest |kernel - plain| over the sums finite in both; with
    ``timing`` also the kernel's time as bare launches, the plain
    version's and ``index_add_``'s on the card, the bound from the flush's
    own lanes."""
    import torch

    from srt_tpu_torch.kernels import film as kfilm

    acc, n_vert, n_nan, pix, rad, fin, alive = rec
    dev = acc.device
    n = pix.shape[0]
    plain = [t.cpu().clone() for t in (acc, n_vert, n_nan)]
    kfilm.film_sum_reference(*plain, pix.cpu(), rad.cpu(), fin.cpu(),
                             alive.cpu())
    err = 0.0
    for run in range(2):
        film = kfilm.Film(acc.shape[1], n, dev)
        for t, src in zip((film.acc, film.n_vertices, film.nan_scrubbed),
                          (acc, n_vert, n_nan)):
            t.copy_(src)
        film.flush(pix, rad, fin, alive)
        torch.cuda.synchronize()
        for name, got, want in zip(("sums", "vertices", "NaN"),
                                   (film.acc, film.n_vertices,
                                    film.nan_scrubbed), plain):
            if not same_tensor_bits(got, want):
                bad = int((got.cpu() != want).sum())
                raise AssertionError(f"film {label}: the kernel's {name} "
                                     f"differ from the plain version's "
                                     f"({bad} values, launch {run + 1})")
        if not film.clean():
            raise AssertionError(f"film {label}: a pixel's row count or "
                                 f"bitmap left set after a launch")
        got = film.acc.cpu()
        ok = torch.isfinite(got) & torch.isfinite(plain[0])
        off = (got - plain[0])[ok].abs()
        err = max(err, float(off.max()) if off.numel() else 0.0)
    done = fin != 0
    n_fin = int(done.sum())
    p_fin = pix[done].long()
    touched = int(torch.unique(p_fin).numel())
    chain = int(torch.bincount(p_fin).max()) if n_fin else 0
    # a pixel's records: the 256-lane tiles its finished lanes lie in
    tiles = torch.nonzero(done).squeeze(1) // 256
    span = n // 256 + 1
    records = (int(torch.bincount(torch.unique(p_fin * span + tiles) // span)
                   .max()) if n_fin else 0)
    shape = (f"{n} lanes, {n_fin} finished into {touched} pixels (the most "
             f"lanes a pixel {chain}, the most records {records})")
    if not timing:
        log(f"[film-{label}] {shape}: the kernel's sums (NaN where the plain"
            f" version's are) and counts equal to the plain version's on the"
            f" CPU to the bit, twice")
        return {"max_abs_err": err}
    args = film.kernel_args(pix, rad, fin, alive)
    ms = [args_launch_ms("srt_film_sum", args, 200) for _ in range(2)]
    g = [t.clone() for t in (acc, n_vert, n_nan)]
    plain_ms = time_ms(lambda: kfilm.film_sum_reference(
        *g, pix, rad, fin, alive), 50)
    contrib = torch.where(done, rad, 0.0).nan_to_num(0.0, float("inf"),
                                                     float("-inf"))
    library_ms = time_ms(lambda: g[0].index_add_(1, pix, contrib), 200)
    ms_bound, by = bound(n * (fin.element_size() + alive.element_size())
                         + n_fin * (pix.element_size() + 12) + touched * 24
                         + 16, 3 * n_fin)
    log(f"[film-{label}] {shape}, {int(((alive != 0) | done).sum())} live: "
        f"the kernel's sums and counts equal to the plain version's on the "
        f"CPU to the bit, twice; ms per launch {ms} (bare), plain on the "
        f"card {plain_ms}, index_add_ {library_ms}, bound {ms_bound:.6f} "
        f"({by})")
    return {"max_abs_err": err, "ms": min(ms), "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": ms_bound, "bound_by": by,
            "shape": shape}


def renders_twice(label: str, scene, cam, cfg) -> dict:
    """``render_regen`` twice on the same settings, counts from 0: the
    images and the counts equal to the bit; each render's film launches
    one a bounce."""
    import numpy as np

    from srt_tpu_torch import render_regen

    reset_counts()
    runs = [render_regen(scene, cam, cfg, metrics=True) for _ in range(2)]
    counts = read_counts()
    (a, ma), (b, mb) = runs
    if not same_tensor_bits(a, b) or (ma.path_vertices, ma.nan_scrubbed) \
            != (mb.path_vertices, mb.nan_scrubbed):
        raise AssertionError(f"{label}: two renders differ "
                             f"({int((a != b).sum())} values; vertices "
                             f"{ma.path_vertices} {mb.path_vertices})")
    if counts["film_sum"] != ma.bounces + mb.bounces:
        raise AssertionError(f"{label}: {counts} for {ma.bounces} bounces "
                             f"a render")
    img = a.cpu().numpy()
    if not np.isfinite(img).all() or ma.nan_scrubbed:
        raise AssertionError(f"{label}: mean {img.mean()}")
    log(f"[twice-{label}] two renders equal to the bit: walls {ma.wall_s:.4f}"
        f" and {mb.wall_s:.4f} s, launches {json.dumps(counts)}, mean "
        f"{float(img.mean()):.6f}")
    return path_record(f"twice {label}", counts, [ma, mb])


def material_sum_inputs(scene, cam, dev, lanes: int) -> tuple:
    """B5's per-lane material cotangents at ``lanes`` lanes (phase 5's
    16,384-lane train state, or the scan train step's 262,144-lane
    wavefront three bounces in), seeded cotangents of its outputs:
    ``(g_mat, wmat, n_mat)``."""
    import numpy as np
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.scene.ir import SceneFlags

    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=TRAIN["max_depth"])
    st = (train_state(scene, cam, flags, tables, spec, dev)
          if lanes == TRAIN_LANES
          else scan_train_state(scene, flags, tables, spec, cam, dev))
    if st["o"].shape[0] != lanes:
        raise AssertionError(f"material sum: {st['o'].shape[0]} lanes")
    r = np.random.default_rng(3)
    ct = {k: torch.from_numpy(r.standard_normal((lanes, 3))
                              .astype(np.float32)).to(dev) for k in kbb.ROWS}
    _, g_mat, wmat = kbb.lane_cotangents(scene, flags, tables, st, ct, spec)
    return g_mat, wmat, tables["mat"].shape[0]


def material_sum_case(scene, cam, dev, lanes: int) -> dict:
    """The material-sum kernel on B5's per-lane outputs at ``lanes``
    lanes (:func:`material_sum_inputs`): twice, equal to the bit;
    against the plain version on the CPU (``index_add_`` lane after lane)
    under the gradient contract, every row of the table within it; its
    time as bare launches, the plain version's and ``index_add_``'s on the
    card, and the bound."""
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import segment as kseg
    from srt_tpu_torch.utils import contract

    g_mat, wmat, n_mat = material_sum_inputs(scene, cam, dev, lanes)
    outs = [kseg.material_sum(g_mat, wmat, n_mat) for _ in range(2)]
    torch.cuda.synchronize()
    if not same_tensor_bits(*outs):
        raise AssertionError(f"material sum at {lanes} lanes: two launches "
                             f"differ")
    ref = kseg.material_sum_reference(g_mat.cpu(), wmat.cpu(), n_mat)
    m = contract.check_grads({"d_mat": ref.numpy()},
                             {"d_mat": outs[0].cpu().numpy()}, frac=0.0)
    if not same_tensor_bits(outs[0], kseg.material_sum_order(
            g_mat.cpu(), wmat.cpu(), n_mat)):
        raise AssertionError(f"material sum at {lanes} lanes: the kernel "
                             f"differs from its order of adds in torch")
    args, _out = kseg.kernel_args(g_mat, wmat, n_mat)
    ms = [args_launch_ms("srt_segment_sum", args, 200) for _ in range(2)]
    plain_ms = time_ms(lambda: kseg.material_sum_reference(
        g_mat, wmat, n_mat), 50)
    k = len(kb.MAT_GRAD_COLS)
    per = torch.zeros((n_mat, k), device=dev)
    idx = wmat.long()
    library_ms = time_ms(lambda: per.index_add_(0, idx, g_mat), 50)
    ms_bound, by = bound(lanes * (4 * k + 4) + n_mat * 14 * 4, lanes * k)
    log(f"[material-sum] {lanes} lanes into {n_mat} rows: two launches "
        f"equal to the bit and to the order of adds in torch on the CPU; "
        f"against the plain version on the CPU {json.dumps(m)}; ms per "
        f"launch {ms} (bare), plain on the card {plain_ms}, index_add_ "
        f"{library_ms}, bound {ms_bound:.6f} ({by})")
    return {"max_abs_err": m["max_abs"], "ms": min(ms), "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": ms_bound, "bound_by": by}


def grads_twice(label: str, scene, cam, params: dict, size: dict, dev,
                engine: str = "regen", record: bool = False) -> dict:
    """One train step's loss and gradient (no Adam) twice from the same
    parameters, counts from 0: equal to the bit, or with ``record`` only
    reported."""
    import torch

    from srt_tpu_torch import make_train_step

    w = size["width"]
    step = make_train_step(scene, cam, params, width=w, height=w,
                           spp=size["spp"], max_depth=size["max_depth"],
                           lr=TRAIN_LR, engine=engine,
                           engine_kw=TRAIN_ENGINE if engine == "regen"
                           else None, device=dev)
    target = step.target(torch.full((w, w, 3), TRAIN_TARGET, device=dev))
    reset_counts()
    t0 = time.time()
    runs = []
    for _ in range(2):
        step.optimizer.zero_grad(set_to_none=True)
        loss = step.loss_fn(step.params, target, 1)
        loss.backward()
        runs.append((loss.detach().clone(),
                     {k: p.grad.clone() for k, p in step.params.items()}))
    torch.cuda.synchronize()
    wall = (time.time() - t0) / 2
    counts = read_counts()
    (la, ga), (lb, gb) = runs
    same = same_tensor_bits(la, lb) and all(same_tensor_bits(ga[k], gb[k])
                                            for k in ga)
    off = {k: int((ga[k] != gb[k]).sum()) for k in ga}
    if not same and not record:
        raise AssertionError(f"{label}: two steps from the same state differ"
                             f" (losses {float(la)} {float(lb)}, gradient "
                             f"entries off {off})")
    if not all(torch.isfinite(g).all() for g in ga.values()):
        raise AssertionError(f"{label}: gradient not finite")
    log(f"[twice-{label}] loss and gradient {'equal to the bit' if same else 'NOT equal'}"
        f" over two runs from the same state (loss {float(la)!r}, entries "
        f"off {off}); launches {json.dumps(counts)}, {wall:.3f} s a step")
    return {"same": same, "path": {"name": f"twice {label}",
                                   "launches": {k: v for k, v in
                                                counts.items() if v},
                                   "wall_s": wall}}


def phase_sums(scene, cam, dev) -> dict:
    """Phase 38 (ROADMAP C18): the film kernel (``csrc/film_sum.cu``)
    against its plain version to the bit on the seeded flushes of
    :data:`SYNTHETIC` and of the tests' layouts
    (``tests/_torch_flushes.py``), on the main path's second flush (a
    pixel's camera
    rays that left the scene finish together) and its flush
    :data:`FLUSH_AT` (65,536 lanes), on the second flush and flush
    :data:`FLUSH_AT` of the main path at :data:`DEEP_SPP` samples (1,024
    camera rays of a pixel finish together), and on one of cornell_boxes'
    per-bounce loop; two ball_scenes renders at 512x512x16x50 and two at
    :data:`DEEP_SPP` samples through B1, and two cornell_boxes renders
    through the per-bounce loop, each pair equal to the bit; the
    material-sum kernel (``csrc/segment_sum.cu``) at :data:`SUM_LANES`;
    the regen-scan and the scan engine's ``{"tex_color"}`` train steps
    twice from the same state, loss and gradient to the bit; the geometry
    step (the hybrid's replay) the same, reported as a record."""
    import torch

    from srt_tpu_torch import RenderConfig, get_scene, render_regen
    from srt_tpu_torch.kernels import build

    report = build.ptxas_report()
    log(f"[sums] registers, spill stores: film_sum_kernel "
        f"{json.dumps(kernel_registers(report, 'film_sum_kernel', True))}, "
        f"segment_sum_kernel "
        f"{json.dumps(kernel_registers(report, 'segment_sum_kernel', True))}")
    cfg = RenderConfig(**MAIN)
    deep = RenderConfig(**dict(MAIN, spp=DEEP_SPP))
    tri_scene, tri_cam, _ = get_scene("cornell_boxes", device=dev)
    checks = [check_flush(f"synthetic {layout}", synthetic_flush(dev, layout,
                                                                n),
                          timing=False) for layout, n in SYNTHETIC]
    from _torch_flushes import FILM_LAYOUTS, film_flush
    for layout in FILM_LAYOUTS:
        acc0, *lanes = (torch.from_numpy(x).to(dev)
                        for x in film_flush(layout))
        checks.append(check_flush(f"layout {layout}", (
            acc0, torch.tensor(3, device=dev), torch.tensor(4, device=dev),
            *lanes), timing=False))
    checks.append(check_flush("ball_scenes second flush", record_flush(
        lambda: render_regen(scene, cam, cfg), 1), timing=False))
    film = check_flush("ball_scenes", record_flush(
        lambda: render_regen(scene, cam, cfg), FLUSH_AT))
    film_deep = {at: check_flush(f"ball_scenes {DEEP_SPP} spp flush {at}",
                                 record_flush(lambda: render_regen(
                                     scene, cam, deep), at))
                 for at in (1, FLUSH_AT)}
    film_tri = check_flush("cornell_boxes", record_flush(
        lambda: render_regen(tri_scene, tri_cam, cfg), FLUSH_AT))
    checks += [film, film_tri, *film_deep.values()]
    paths = [renders_twice("ball_scenes B1", scene, cam, cfg),
             renders_twice(f"ball_scenes B1 {DEEP_SPP} spp", scene, cam,
                           deep),
             renders_twice("cornell_boxes per-bounce", tri_scene, tri_cam,
                           cfg)]
    sums = {n: material_sum_case(scene, cam, dev, n) for n in SUM_LANES}
    tex = {"tex_color": scene.tex_color}
    steps = {e: grads_twice(f"{e} tex_color step", scene, cam, tex, TRAIN,
                            dev, engine=e) for e in ("regen", "scan")}
    geom = grads_twice("geometry step (record)", scene, cam,
                       {k: getattr(scene, k) for k in GEOM_PARAMS},
                       HYBRID_RICH, dev, record=True)
    for e, s in steps.items():
        if not s["path"]["launches"].get("segment_sum"):
            raise AssertionError(f"the {e} train step launched no material "
                                 f"sum")
    paths += [s["path"] for s in steps.values()] + [geom["path"]]
    return {"film": film, "film_tri": film_tri, "film_deep": film_deep,
            "film_err": max(c["max_abs_err"] for c in checks),
            "sums": sums, "geom_same": geom["same"], "paths": paths}


def phase_bench(root: str) -> dict:
    """Phase 39: ``python -m srt_tpu_torch.bench --engine both
    --min-seconds 0 --matrix`` in a subprocess: the main cell through both
    engines, ``tri_scene``, and every library scene at :data:`MATRIX`
    (``bench.py``'s 256x256x8 cut for the time limit; depth 50) with
    ``--matrix-out``: its JSON line parsed, every key of ``bench.py``'s
    plus ``backend``, no NaN pixel and a finite mean on every scene, the
    artifact's keys."""
    import math
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="srt_bench_")
    try:
        art = os.path.join(tmp, "matrix.json")
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "srt_tpu_torch.bench", "--engine", "both",
             "--min-seconds", "0", "--matrix", "--matrix-width",
             str(MATRIX["width"]), "--matrix-spp", str(MATRIX["spp"]),
             "--matrix-out", art], cwd=root, env=env, capture_output=True,
            text=True, timeout=3 * BENCH_BUDGET_S)
        wall = time.time() - t0
        if proc.returncode:
            raise AssertionError(f"bench: {proc.stderr[-3000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(art) as f:
            artifact = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    keys = {"metric", "value", "unit", "vs_baseline", "baseline_rays_per_sec",
            "scene", "engine", "engines", "config", "device", "wall_s",
            "warmup_s", "nan_pixels", "backend", "tri_scene", "matrix"}
    scene_keys = {"n_tris", "primary_rays_per_sec", "path_vertices_per_sec",
                  "wall_s", "warmup_s", "nan_pixels", "mean"}
    from srt_tpu_torch.scene.library import list_scenes
    bad = {n: e for n, e in rec.get("matrix", {}).items()
           if not scene_keys <= set(e) or e["nan_pixels"]
           or not math.isfinite(e["mean"])}
    if (not keys <= set(rec) or set(rec["engines"]) != {"regen", "scan"}
            or set(rec["warmup_s"]) != {"regen", "scan"}
            or rec["backend"] != "torch-cuda" or rec["nan_pixels"]
            or rec["tri_scene"]["nan_pixels"] or bad
            or sorted(rec["matrix"]) != sorted(list_scenes())
            or sorted(artifact["scenes"]) != sorted(list_scenes())
            or not {"what", "workload", "date"} <= set(artifact)):
        raise AssertionError(f"bench: {json.dumps(rec)[:3000]} bad {bad}")
    for line in proc.stderr.splitlines():
        if line.startswith(("[tri]", "[regen]", "[scan]")):
            log(f"[bench] {line}")
    log(f"[bench] budget {BENCH_BUDGET_S} s, took {wall:.1f} s; the matrix "
        f"cut to {MATRIX['width']}x{MATRIX['width']}x{MATRIX['spp']} depth "
        f"50 (bench.py: 256x256x8); {json.dumps(rec)}")
    return {"paths": [{"name": "bench --engine both --matrix",
                       "launches": {}, "wall_s": wall}]}


def b3_states(dev):
    """B3's inputs that ``--compare`` times: ``(label, scene, o, d)`` of
    phase 7's cornell_boxes render wavefront, phase 16's cornell_boxes
    train state and phase 7's ``final`` ground field."""
    from srt_tpu_torch import get_scene
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.scene.ir import SceneFlags

    scene, cam, _ = get_scene("cornell_boxes", device=dev)
    st = step_wavefront(scene, cam, dev)[0]
    yield "b3 cornell render", scene, st["o"], st["d"]
    flags = SceneFlags.of(scene)
    spec = kb.StepSpec(max_depth=CORNELL_TRAIN["max_depth"])
    st = train_state(scene, cam, flags, kb.build_tables(scene, flags), spec,
                     dev, size=CORNELL_TRAIN)
    yield "b3 cornell train", scene, st["o"], st["d"]
    yield "b3 final ground", *ground_field(dev)


def cornell_times(dev) -> dict:
    """``--measure`` on the triangle walk: B3 as bare launches on each
    state of :func:`b3_states`, ``COMPARE_ROUNDS`` times at the wrapper's
    G and once at each G where the checkout picks one, with the digests
    of its inputs (the triangles and the rays) and per-ray outputs; B2's
    external hit on phase 7's render wavefront (with the digests of its
    inputs and per-lane outputs); and two steps of phase 16's train
    cell."""
    import ctypes

    import torch

    from srt_tpu_torch import get_scene
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.scene.ir import SceneFlags

    out = {"b3_ms": {}, "b3_shares_ms": {}, "b2_ext_ms": [],
           "digests": {}}
    for label, scene, o, d in b3_states(dev):
        packed = ki.pack_tables(scene)
        hit = ki.intersect_tris(scene, packed, o, d)
        torch.cuda.synchronize()
        out["digests"][label] = [digest(scene.tri_p0, scene.tri_p1,
                                        scene.tri_p2, o, d), digest(*hit)]

        def bare():
            return bare_launch_ms(
                "srt_intersect_tris", ctypes.sizeof(ki._Args),
                lambda: ki.intersect_tris(scene, packed, o, d), 200)
        out["b3_ms"][label] = [bare() for _ in range(COMPARE_ROUNDS)]
        out["b3_shares_ms"][label] = shares_times(bare, WALK)
    scene, cam, _ = get_scene("cornell_boxes", device=dev)
    flags = SceneFlags.of(scene)
    st, inp, step, _ = step_wavefront(scene, cam, dev)
    tri = ki.intersect_tris(scene, ki.pack_tables(scene), st["o"], st["d"])
    out["digests"]["b2 ext cornell"] = b2_digests(scene, flags, inp.tables,
                                                  st, step, tri)
    out["b2_ext_ms"] = [b2_launch_ms(scene, flags, inp.tables, st, step,
                                     tri) for _ in range(COMPARE_ROUNDS)]
    out["train_s"] = train_walls(scene, cam, {"tex_color": scene.tex_color},
                                 CORNELL_TRAIN, dev, 2)[3]
    return out


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order (the first 16 hex digits)."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# the wavefront planes B1 reads and writes per lane, and the cursor (the
# per-block dead counts follow the kernel's lanes a block, and stay out)
B1_PLANES = ("o", "d", "time", "beta", "radiance", "salt", "depth", "alive",
             "pix", "fin", "cursor")
# B2's per-lane inputs and outputs (parity adds the stale plane)
B2_IN = ("o", "d", "time", "beta", "radiance", "salt", "depth", "alive")
B2_OUT = ("o", "d", "beta", "radiance", "depth", "alive")


def b2_digests(scene, flags, tables, st, step, tri=None) -> list:
    """The digests of one B2 launch's inputs (the state, the triangle hit)
    and of its per-lane outputs."""
    import torch

    from srt_tpu_torch.kernels import bounce as kb

    out = kb.bounce_fwd(scene, flags, tables, st, step, tri)
    torch.cuda.synchronize()
    keys = B2_OUT + (("stale",) if flags.ref_parity else ())
    return [digest(*(st[k] for k in B2_IN), *(tri or ())),
            digest(*(out[k] for k in keys))]


def b1_states(dev):
    """B1's inputs that ``--compare`` times: ``(label, inputs, wavefront,
    spec)`` of phase 3's ball_scenes wavefront (lean) and phase 17's
    random_scene one (rich, 484 moving spheres)."""
    import numpy as np
    import torch

    from srt_tpu_torch.core.sobol import sobol_points
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.scene.ir import SceneFlags

    spec = kb.RegenSpec(width=512, height=512, spp=16, max_depth=50,
                        rr_start=1 << 30, pdf_floor=1e-9, seed=0)
    jitter = torch.from_numpy(sobol_points(16, 2).astype(np.float32))
    for name, cursor in (("ball_scenes", spec.total_work // 2),
                         ("random_scene", dict(RICH_CASES)["random_scene"]
                          * spec.width * spec.spp)):
        scene, cam = rich_scene(name, dev)
        inp = kb.RegenInputs(scene, SceneFlags.of(scene), cam, jitter)
        yield f"b1 {name}", inp, b1_wavefront(inp, spec, dev, cursor), spec


def b2_states(dev):
    """B2's inputs that ``--compare`` times: ``(label, scene, flags,
    tables, state, spec, triangle hit)`` of the train states of phases 5
    and 19 (the states B5 reads, ``b5_states``), phase 20 (random_scene,
    moving spheres) and phase 16 (cornell_boxes, B3's hit as the external
    hit), and phase 21's ball_scenes parity wavefronts with and without
    ``parity_no_stale``."""
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.scene.ir import SceneFlags

    for name, scene, flags, tables, st, _, spec in b5_states(dev):
        yield f"b2 {name} train", scene, flags, tables, st, spec, None
    spec = kb.StepSpec(max_depth=TRAIN["max_depth"])
    for name, size in (("random_scene", TRAIN),
                       ("cornell_boxes", CORNELL_TRAIN)):
        scene, cam = rich_scene(name, dev)
        flags = SceneFlags.of(scene)
        tables = kb.build_tables(scene, flags)
        st = train_state(scene, cam, flags, tables, spec, dev, size=size)
        tri = (ki.closest_tris(scene, ki.pack_walk(scene), st["o"], st["d"])
               if scene.n_tris else None)
        yield f"b2 {name} train", scene, flags, tables, st, spec, tri
    for no_stale in (False, True):
        scene, cam, flags = parity_scene("ball_scenes", dev, no_stale)
        st, inp, step, _ = step_wavefront(scene, cam, dev, flags=flags)
        yield (f"b2 parity{'_no_stale' if no_stale else ''} ball_scenes",
               scene, flags, inp.tables, st, step, None)


def shares_times(fn, kind: tuple = SWEEP) -> dict | None:
    """``fn()`` with the kernels of ``kind`` at each of the checkout's Gs;
    None where its wrapper picks no G."""
    mod, name, gs = picker(kind)
    if not hasattr(mod, name):
        return None
    out = {}
    for g in gs:
        with shares(g, kind):
            out[g] = fn()
    return out


def bounce_times(dev) -> dict:
    """``--measure``: B1 on each state of :func:`b1_states` (50 launches a
    round) and B2 on each of :func:`b2_states` (200) as bare launches,
    ``COMPARE_ROUNDS`` rounds at the wrapper's G and one at each G
    (``shares_times``), and B6 on the ball_scenes and random_scene train
    states' rays the same way (200), with the digests of each launch's
    inputs and per-lane outputs."""
    import ctypes

    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import spheres as ks

    out = {"ms": {}, "shares_ms": {}, "digests": {}}
    for label, inp, mid, spec in b1_states(dev):
        st = clone(mid)
        kb.regen_bounce(inp, st, spec)
        torch.cuda.synchronize()
        out["digests"][label] = [digest(*(mid[k] for k in B1_PLANES)),
                                 digest(*(st[k] for k in B1_PLANES))]
        out["ms"][label] = [b1_launch_ms(inp, mid, spec, 50)
                            for _ in range(COMPARE_ROUNDS)]
        out["shares_ms"][label] = shares_times(
            lambda: b1_launch_ms(inp, mid, spec, 50))
    for label, scene, flags, tables, st, step, tri in b2_states(dev):
        out["digests"][label] = b2_digests(scene, flags, tables, st, step,
                                           tri)

        def bare():
            return b2_launch_ms(scene, flags, tables, st, step, tri)
        out["ms"][label] = [bare() for _ in range(COMPARE_ROUNDS)]
        out["shares_ms"][label] = shares_times(bare)
        if label in ("b2 ball_scenes train", "b2 random_scene train"):
            # B6 on the same rays: the sphere test it shares with B1 and B2
            b6 = "b6" + label[2:]
            ray = (st["o"], st["d"], st["time"])
            out["digests"][b6] = [digest(tables["sph"], *ray), digest(
                *ks.sphere_winner(scene, tables["sph"], *ray))]

            def b6_bare():
                return bare_launch_ms(
                    "srt_sphere_winner", ctypes.sizeof(ks._Args),
                    lambda: ks.sphere_winner(scene, tables["sph"], *ray),
                    200)
            out["ms"][b6] = [b6_bare() for _ in range(COMPARE_ROUNDS)]
            # where the checkout's B6 takes G (a launch field)
            out["shares_ms"][b6] = (
                shares_times(b6_bare)
                if "shares" in dict(ks._Args._fields_) else None)
    return out


def b5_states(dev):
    """B5's inputs of phases 5 and 19: ``(name, scene, flags, tables,
    state, cotangents, spec)`` of the 16,384-lane train state of
    ball_scenes (lean) and of each scene of ``RICH_BWD_EXPECT`` (rich),
    the cotangents of o, d and beta zero where the plain step ends the
    path."""
    import numpy as np
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.scene.ir import SceneFlags

    spec = kb.StepSpec(max_depth=TRAIN["max_depth"])
    for name, seed in (("ball_scenes", 2),
                       *((k, 5) for k in RICH_BWD_EXPECT)):
        scene, cam = rich_scene(name, dev)
        flags = SceneFlags.of(scene)
        tables = kb.build_tables(scene, flags)
        st = train_state(scene, cam, flags, tables, spec, dev)
        with torch.no_grad():
            ends = ~kb.bounce_step_ref(scene, flags, tables["mat"], st,
                                       spec)["alive"]
        r = np.random.default_rng(seed)
        ct = {k: torch.from_numpy(r.standard_normal((TRAIN_LANES, 3))
                                  .astype(np.float32)).to(dev)
              for k in kbb.ROWS}
        for k in ("o", "d", "beta"):
            ct[k][ends] = 0.0
        yield name, scene, flags, tables, st, ct, spec


def b5_bare_times(dev) -> dict:
    """``--measure``: B5 as bare launches on each state of
    :func:`b5_states`, ``COMPARE_ROUNDS`` times, 200 launches each, with
    the digests of its inputs (the state and the cotangents) and of its
    per-lane outputs (``lane_cotangents``, before the segment sum)."""
    import ctypes

    import torch

    from srt_tpu_torch.kernels import bounce_bwd as kbb

    out = {"ms": {}, "digests": {}}
    for name, scene, flags, tables, st, ct, spec in b5_states(dev):
        g, g_mat, wmat = kbb.lane_cotangents(scene, flags, tables, st, ct,
                                             spec)
        torch.cuda.synchronize()
        out["digests"][f"b5 {name}"] = [
            digest(*(st[k] for k in ("o", "d", "beta", "radiance", "salt",
                                     "depth", "alive")),
                   *(ct[k] for k in kbb.ROWS)),
            digest(*(g[k] for k in kbb.ROWS), g_mat, wmat)]
        out["ms"][name] = [bare_launch_ms(
            "srt_bounce_bwd", ctypes.sizeof(kbb._BwdArgs),
            lambda: kbb.lane_cotangents(scene, flags, tables, st, ct, spec),
            200) for _ in range(COMPARE_ROUNDS)]
    return out


def teapot_times(dev) -> dict:
    """``--measure`` on teapot_scene (divs=100): B4 as bare launches on
    phase 10's bounced rays, ``COMPARE_ROUNDS`` times, 50 launches each,
    and B2's external hit on that wavefront (200 launches each), with the
    digests of their inputs and per-lane outputs; then the teapot
    render path (phase 12's settings), once to warm up and
    ``TRI_MAIN_REPS`` times timed, its primary rays a second."""
    import ctypes

    import torch

    from srt_tpu_torch import RenderConfig, render_regen
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.scene.ir import SceneFlags

    scene, cam = teapot(dev)
    st, inp, step, _ = step_wavefront(scene, cam, dev, row=TEAPOT_ROW)
    o, d = st["o"], st["d"]
    big = ki.pack_big_tables(scene)
    hit = ki.intersect_tris_big(scene, big, o, d)
    torch.cuda.synchronize()
    flags = SceneFlags.of(scene)
    out = {"digests": {"b4 bounced": [digest(o, d), digest(*hit)],
                       "b2 ext teapot": b2_digests(scene, flags, inp.tables,
                                                   st, step, hit)}}
    out["b4_bare_ms"] = [bare_launch_ms(
        "srt_intersect_big", ctypes.sizeof(ki._BigArgs),
        lambda: ki.intersect_tris_big(scene, big, o, d), 50)
        for _ in range(COMPARE_ROUNDS)]
    out["b2_ext_ms"] = [b2_launch_ms(scene, flags, inp.tables, st, step, hit)
                        for _ in range(COMPARE_ROUNDS)]
    cfg = RenderConfig(**MAIN)
    render_regen(scene, cam, cfg)
    torch.cuda.synchronize()
    out["render_rays_per_s"] = [
        render_regen(scene, cam, cfg, metrics=True)[1].primary_rays_per_sec
        for _ in range(TRI_MAIN_REPS)]
    return out


#: ``--compare``: the film flushes it times, phase 38's: (label, scene,
#: samples a pixel, flush)
FLUSH_CASES = (("ball_scenes flush 40", "ball_scenes", 16, FLUSH_AT),
               ("cornell_boxes flush 40", "cornell_boxes", 16, FLUSH_AT),
               ("1,024 spp flush 1", "ball_scenes", DEEP_SPP, 1),
               ("1,024 spp flush 40", "ball_scenes", DEEP_SPP, FLUSH_AT))


def sums_times(dev) -> dict:
    """``--compare``: the film kernel on :data:`FLUSH_CASES` and the
    material sum at :data:`SUM_LANES`, each beside ``index_add_`` on the
    same inputs, by :func:`three_timers` (bare launches); the film's
    digests (its inputs; its sums and counts after one launch, the plain
    version's bits in every checkout) and the material sum's (its inputs;
    its table, whose order a checkout may change: reported, not held to
    the other checkouts')."""
    import torch

    from srt_tpu_torch import RenderConfig, get_scene, render_regen
    from srt_tpu_torch.kernels import film as kfilm
    from srt_tpu_torch.kernels import segment as kseg

    out = {k: {} for k in ("film", "film_index_add", "segment",
                           "segment_index_add", "digests",
                           "segment_digests")}
    scenes = {}
    for label, name, spp, at in FLUSH_CASES:
        if name not in scenes:
            scenes[name] = get_scene(name, device=dev)[:2]
        scene, cam = scenes[name]
        cfg = RenderConfig(**dict(MAIN, spp=spp))
        rec = record_flush(lambda: render_regen(scene, cam, cfg), at)
        acc, n_vert, n_nan, pix, rad, fin, alive = rec
        film = kfilm.Film(acc.shape[1], pix.shape[0], dev)
        for t, src in zip((film.acc, film.n_vertices, film.nan_scrubbed),
                          (acc, n_vert, n_nan)):
            t.copy_(src)
        film.flush(pix, rad, fin, alive)
        torch.cuda.synchronize()
        out["digests"][f"film {label}"] = [
            digest(*rec), digest(film.acc, film.n_vertices,
                                 film.nan_scrubbed)]
        out["film"][label] = three_timers(bare_call(
            "srt_film_sum", film.kernel_args(pix, rad, fin, alive)))
        contrib = torch.where(fin != 0, rad, 0.0).nan_to_num(
            0.0, float("inf"), float("-inf"))
        g = acc.clone()
        out["film_index_add"][label] = three_timers(
            lambda: g.index_add_(1, pix, contrib))
    scene, cam = scenes["ball_scenes"]
    for n in SUM_LANES:
        g_mat, wmat, n_mat = material_sum_inputs(scene, cam, dev, n)
        held = kseg.kernel_args(g_mat, wmat, n_mat)   # args, table[, part]
        out["segment"][str(n)] = three_timers(bare_call("srt_segment_sum",
                                                        held[0]))
        per = torch.zeros((n_mat, g_mat.shape[1]), device=dev)
        idx = wmat.long()
        out["segment_index_add"][str(n)] = three_timers(
            lambda: per.index_add_(0, idx, g_mat))
        table = kseg.material_sum(g_mat, wmat, n_mat)
        out["segment_digests"][f"material sum {n}"] = [digest(g_mat, wmat),
                                                       digest(table)]
        del held
    return out


#: ``--compare``'s profiled kernels, each known by its profiler name
PROFILED = {"film": lambda k: "film_sum_kernel" in k,
            "material sum": lambda k: "segment_sum_kernel" in k,
            "B1": lambda k: "regen_bounce_kernel" in k,
            "B2": lambda k: "bounce_kernel<" in k and "regen_" not in k,
            "B5": lambda k: "bounce_bwd_kernel" in k}


def profile_kernels(dev) -> dict:
    """``--compare``: ``torch.profiler``'s device rows over one ball_scenes
    render (512x512x16x50) and one regen-scan train step (the train cell,
    ``{"tex_color"}``), each after one unprofiled run: the launches and
    microseconds a launch of each kernel of :data:`PROFILED`, and the
    device's busy microseconds (every device row)."""
    import torch

    from srt_tpu_torch import RenderConfig, get_scene, render_regen

    scene, cam, _ = get_scene("ball_scenes", device=dev)
    cfg = RenderConfig(**MAIN)
    step, _, _, _ = train_walls(scene, cam, {"tex_color": scene.tex_color},
                                TRAIN, dev, 0)
    target = torch.full((TRAIN["width"],) * 2 + (3,), TRAIN_TARGET,
                        device=dev)
    render_regen(scene, cam, cfg)
    out = {}
    for label, fn in (("render", lambda: render_regen(scene, cam, cfg)),
                      ("train step", lambda: step(target, 1))):
        _, rows = device_rows(fn)
        kern = {}
        for name, named in PROFILED.items():
            hits = [v for k, v in rows.items() if named(k)]
            calls, us = sum(h[0] for h in hits), sum(h[1] for h in hits)
            if calls:
                kern[name] = {"launches": calls, "us_a_launch": us / calls}
        out[label] = {"busy_us": sum(v[1] for v in rows.values()),
                      "kernels": kern}
    return out


def measure_tree() -> dict:
    """``--measure``: what ``--compare`` times in one checkout, with the
    package found first on ``sys.path``: its build, ``ptxas``' registers
    and spill stores of B1, B2, B3, B4, B5 and B6, B1 on phase 3's
    ball_scenes wavefront as bare launches and through its wrapper
    (``COMPARE_ROUNDS`` times, 50 launches each), B1 and B2 on their other
    states (``bounce_times``), B5 as bare launches (``b5_bare_times``), B4,
    B2's external hit and the teapot render (``teapot_times``), the
    ball_scenes train step with ``{"tex_color"}`` (phase 6, three steps)
    and with the geometric parameters (phase 15, two steps), and
    ``cornell_times``, the film and material sums beside ``index_add_``
    (``sums_times``) and the profiler's kernel rows over a render and a
    train step (``profile_kernels``). A measurement the checkout's package
    cannot make holds its error instead."""
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
    out["registers"] = {k: kernel_registers(report, k, True) for k in
                        ("regen_bounce_kernel", "bounce_kernel",
                         "bounce_bwd_kernel", "intersect_tris_kernel",
                         "intersect_big_kernel", "sphere_winner_kernel")}
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
            ("bounce", lambda: bounce_times(dev)),
            ("b5", lambda: b5_bare_times(dev)),
            ("teapot", lambda: teapot_times(dev)),
            ("train_s", lambda: train_walls(
                scene, cam, {"tex_color": scene.tex_color}, TRAIN, dev,
                TRAIN_STEPS)[3]),
            ("geom_train_s", lambda: train_walls(
                scene, cam, {k: getattr(scene, k) for k in GEOM_PARAMS},
                TRAIN, dev, 2)[3]),
            ("cornell", lambda: cornell_times(dev)),
            ("sums", lambda: sums_times(dev)),
            ("profile", lambda: profile_kernels(dev))):
        try:
            out[key] = fn()
        except Exception as e:      # a path this checkout does not have
            out[key] = f"{type(e).__name__}: {e}"[:300]
    return out


def bench_profile(path: str, spp: int) -> dict:
    """``python -m srt_tpu_torch.bench --spp spp --profile DIR`` in the
    checkout ``path`` (ball_scenes 512x512xspp x50): its rays per second
    and, from its ``[profile]`` lines, the wall with the profiler off and
    the device's busy seconds."""
    import re
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="srt_profile_")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "srt_tpu_torch.bench", "--spp", str(spp),
             "--min-seconds", "3", "--profile", tmp], cwd=path,
            capture_output=True, text=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if proc.returncode:
        return {"error": proc.stderr[-1000:]}
    out = {"rays_per_s": json.loads(
        proc.stdout.strip().splitlines()[-1])["value"]}
    for line in proc.stderr.splitlines():
        m = re.search(r"device busy ([\d.]+)s", line)
        if m:
            out["busy_s"] = float(m[1])
        m = re.search(r"wall per render with the profiler off: ([\d.]+)",
                      line)
        if m:
            out["wall_s"] = float(m[1])
    return out


def compare(trees: list) -> None:
    """``--compare``: each checkout in ``trees`` in turns, in the order
    given and then in reverse (A B C C B A), each time in fresh processes
    that import that checkout's package and build its kernels from its own
    sources: ``measure_tree`` with this script's timers, then
    ``python -m srt_tpu_torch.bench`` (ball_scenes 512x512x16x50) and
    ``bench --spp 1024 --profile`` (:func:`bench_profile`) from the
    checkout. Prints a line per run and each checkout's extremes; fails
    when the same inputs gave different outputs (B1-B6 and the film; the
    material sum's table is reported by digest, its order being the
    checkout's own)."""
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
        res["bench_deep"] = bench_profile(path, DEEP_SPP)
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
        "b5_bare_ms": {k: extremes(rs, "b5", "ms", k)
                       for k in rs[0]["b5"]["ms"]}
        if isinstance(rs[0].get("b5"), dict) else rs[0].get("b5"),
        "bounce_ms": {k: extremes(rs, "bounce", "ms", k)
                      for k in rs[0]["bounce"]["ms"]}
        if isinstance(rs[0].get("bounce"), dict) else rs[0].get("bounce"),
        "bounce_shares_ms": {k: {g: extremes(rs, "bounce", "shares_ms", k, g)
                                 for g in (v or {})}
                             for k, v in rs[0]["bounce"]["shares_ms"].items()}
        if isinstance(rs[0].get("bounce"), dict) else None,
        "b4_bare_ms": extremes(rs, "teapot", "b4_bare_ms"),
        "teapot_b2_ext_ms": extremes(rs, "teapot", "b2_ext_ms"),
        "teapot_rays_per_s": extremes(rs, "teapot", "render_rays_per_s"),
        "bench_rays_per_s": extremes(rs, "bench_rays_per_s"),
        "train_s": extremes(rs, "train_s"),
        "geom_train_s": extremes(rs, "geom_train_s"),
        "cornell_train_s": extremes(rs, "cornell", "train_s"),
        "b3_ms": {k: extremes(rs, "cornell", "b3_ms", k)
                  for k in rs[0]["cornell"]["b3_ms"]}
        if isinstance(rs[0].get("cornell"), dict) else rs[0].get("cornell"),
        "b3_shares_ms": {k: {g: extremes(rs, "cornell", "b3_shares_ms", k, g)
                             for g in (v or {})}
                         for k, v in rs[0]["cornell"]["b3_shares_ms"].items()}
        if isinstance(rs[0].get("cornell"), dict) else None,
        "cornell_b2_ext_ms": extremes(rs, "cornell", "b2_ext_ms"),
        "registers": rs[0]["registers"],
        "sums_ms": {part: {k: {how: extremes(rs, "sums", part, k, how)
                               for how in ("loop", "graph", "device")}
                           for k in rs[0]["sums"][part]}
                    for part in ("film", "film_index_add", "segment",
                                 "segment_index_add")}
        if isinstance(rs[0].get("sums"), dict) else rs[0].get("sums"),
        "profile_us_a_launch": {
            run: {k: extremes(rs, "profile", run, "kernels", k,
                              "us_a_launch")
                  for k in rs[0]["profile"][run]["kernels"]}
            for run in rs[0]["profile"]}
        if isinstance(rs[0].get("profile"), dict) else rs[0].get("profile"),
        "bench_deep": {k: extremes(rs, "bench_deep", k)
                       for k in ("rays_per_s", "wall_s", "busy_s")},
        "segment_tables": {k: sorted({r["sums"]["segment_digests"][k][1]
                                      for r in rs})
                           for k in rs[0]["sums"]["segment_digests"]}
        if isinstance(rs[0].get("sums"), dict) else None}
        for t, rs in runs.items()}))
    # the same inputs must give the same outputs in every run of every tree
    outs = {}
    for tree, rs in runs.items():
        for r in rs:
            for part in ("bounce", "b5", "teapot", "cornell", "sums"):
                digests = (r[part].get("digests", {})
                           if isinstance(r.get(part), dict) else {})
                for k, (d_in, d_out) in digests.items():
                    outs.setdefault((k, d_in), {}).setdefault(
                        d_out, []).append(tree)
    log("[compare] digests " + json.dumps(
        {f"{k} in {d_in}": v for (k, d_in), v in outs.items()}))
    split = {f"{k} in {d_in}": v for (k, d_in), v in outs.items()
             if len(v) > 1}
    if split:
        raise SystemExit(f"--compare: the same inputs gave different outputs "
                         f"{json.dumps(split)}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ppm", default=None,
                    help="also write the main-path image (sqrt gamma) here")
    ap.add_argument("--compare", nargs="+", metavar="TREE",
                    help="instead of the smoke run, time B1, B2, B3, B4, "
                    "B5, the ball_scenes and teapot renders and the train "
                    "steps of each checkout in turns")
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
        sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]
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
    b1 = timed(3, phase_regen_kernel, scene, cam, dev)
    b1["launches"], film_main = timed(4, phase_render, scene, cam, args.ppm)
    b2, b5 = timed(5, phase_train_kernels, scene, cam, dev)
    b2_train, b5["launches"], sums_train = timed(6, phase_train, scene, cam,
                                                 dev)
    tri_scene, tri_cam, _ = get_scene("cornell_boxes", device=dev)
    b3, b2_ext = timed(7, phase_tri_kernels, tri_scene, tri_cam, dev)  # + 8
    b3["launches"], b2_render, film_tri = timed(9, phase_tri_render,
                                                tri_scene, tri_cam)
    pot, pot_cam = teapot(dev)
    b4, b2_pot = timed(10, phase_teapot_kernels, pot, pot_cam, dev)  # + 11
    b4["launches"], b2_pot_render = timed(12, phase_teapot_render, pot,
                                          pot_cam)
    del pot
    b6 = timed(13, phase_winner, scene, cam, dev)
    timed(14, phase_moving_bounces, scene, cam, dev)
    b2_geom, b6["launches"] = timed(15, phase_geom_train, scene, cam, dev)
    b3_train, b2_cornell, b3_ct, b2_ct = timed(16, phase_cornell_train, dev)
    rich = timed(17, phase_rich_kernel, dev)
    b2_final = timed(18, phase_final_ext, dev)
    b1_rich = timed(18, phase_rich_render, dev)
    rich_bwd = timed(19, phase_rich_bwd, dev)
    rich_train = timed(20, phase_rich_train, dev)
    b2_parity = timed(21, phase_parity_kernel, dev)
    b2_parity["launches"], b3_parity = timed(22, phase_parity_render, dev)
    timed(23, phase_golden, root, dev)
    scan = timed(24, check_scan_path, "scan-ball_scenes", scene, cam,
                 SCAN_REPS)
    scan_tri = timed(25, check_scan_path, "scan-cornell_boxes", tri_scene,
                     tri_cam, SCAN_REPS)
    seq = timed(26, phase_seq_stale, dev)
    resumable = timed(27, phase_resumable, scene, cam, scan["img"])
    cli_paths = timed(28, phase_cli, root, tri_scene, tri_cam,
                      scan_tri["img"])
    del tri_scene
    scan_train = timed(29, phase_scan_train, scene, cam, dev)
    a7 = timed(30, phase_a7, dev)
    atlas = timed(31, phase_atlas, dev)
    merl = timed(32, phase_merl, dev)
    meshes = timed(33, phase_mesh_scenes, dev)
    sharded = timed(34, phase_dist, root, scene, cam, dev)
    field = timed(35, phase_sphere_bvh, dev)
    scaling = timed(36, phase_scaling, root)
    tools = timed(37, phase_tools, root, dev)
    sums = timed(38, phase_sums, scene, cam, dev)
    bench = timed(39, phase_bench, root)
    new_paths = ([scan["path"], scan_tri["path"], seq["path"],
                  resumable["path"]] + cli_paths + [scan_train["path"]]
                 + a7["paths"] + atlas["paths"] + merl["paths"]
                 + meshes["paths"] + sharded["paths"] + field["paths"]
                 + scaling["paths"] + tools["paths"] + sums["paths"]
                 + bench["paths"])
    log(f"[kernels] phases 31-34: launches {json.dumps(atlas['counts'])} "
        f"on the float-atlas paths, B3 {merl['B3']} on the MERL paths, B3 "
        f"{meshes['B3']}, B4 {meshes['B4']} and B2 {meshes['B2']} on the "
        f"mesh-asset paths, B2 {sharded['B2']} on render_sharded; B2 on the "
        f"float atlas {atlas['b2']['ms']} ms (bound "
        f"{atlas['b2']['bound_ms']}); B3 on cornell_box's bunny "
        f"{meshes['b3']['ms']} ms (plain {meshes['b3']['plain_ms']}, bound "
        f"{meshes['b3']['bound_ms']}); B4 on the teapot with its meshes "
        f"{meshes['b4']['ms']} ms (plain {meshes['b4']['plain_ms']}, bound "
        f"{meshes['b4']['bound_ms']})")
    log(f"[kernels] B2 at the scan engine's 524,288 lanes: ball_scenes "
        f"{scan['b2']['ms']} ms (plain {scan['b2']['plain_ms']}, bound "
        f"{scan['b2']['bound_ms']}, {scan['b2']['bound_by']}), "
        f"cornell_boxes with B3's hit {scan_tri['b2']['ms']} ms (plain "
        f"{scan_tri['b2']['plain_ms']}, bound {scan_tri['b2']['bound_ms']}"
        f"); B3 there {scan_tri['b3']['ms']} ms (plain "
        f"{scan_tri['b3']['plain_ms']}, bound {scan_tri['b3']['bound_ms']})")
    log(f"[kernels] B2 parity launches: {b2_parity['launches']} on the "
        f"ball_scenes and cornell_boxes parity render paths ({b3_parity} "
        f"B3 on cornell_boxes'); ms per launch "
        f"{json.dumps(b2_parity['cases'])}")
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
    b3_cornell = b3["launches"]
    b3_a7 = sum(c["B3"] for c in a7["counts"])
    b3["launches"] += (b3_train + b3_parity + scan_tri["counts"]["B3"]
                       + b3_a7)
    b3["max_abs_err"] = max(b3["max_abs_err"], b3_ct["max_abs_err"],
                            scan_tri["b3"]["max_abs_err"])
    b2["launches"] = (b2_train + b2_render + b2_pot_render + b2_geom
                      + b2_cornell + rich_train["b2"]
                      + scan["counts"]["B2"] + scan_tri["counts"]["B2"]
                      + resumable["counts"]["B2"]
                      + scan_train["counts"]["B2"])
    b2["max_abs_err"] = max(b2["max_abs_err"], b2_ext["max_abs_err"],
                            b2_pot["max_abs_err"], b2_ct["max_abs_err"],
                            b2_final["max_abs_err"], rich_bwd["b2_err"],
                            rich_train["b2_moving"]["max_abs_err"],
                            scan["b2"]["max_abs_err"],
                            scan_tri["b2"]["max_abs_err"])
    b2_parity["launches"] += seq["counts"]["B2 parity"]
    b5["launches"] += scan_train["counts"]["B5"]
    # phases 31-34's paths, each read from counts set to 0 just before it
    b1["launches"] += atlas["counts"]["B1"]
    b2["launches"] += atlas["counts"]["B2"] + meshes["B2"] + sharded["B2"]
    b3["launches"] += merl["B3"] + meshes["B3"]
    b4["launches"] += meshes["B4"]
    b5["launches"] += atlas["counts"]["B5"]
    b6["launches"] += atlas["counts"]["B6"]
    # phase 37's in-process paths (the parity chunks, the regions' renders)
    for path in tools["paths"]:
        for key, kern in (("B1", b1), ("B2", b2), ("B2 parity", b2_parity),
                          ("B3", b3), ("B4", b4), ("B5", b5), ("B6", b6)):
            kern["launches"] += path["launches"].get(key, 0)
    b2["max_abs_err"] = max(b2["max_abs_err"], atlas["b2"]["max_abs_err"])
    b3["max_abs_err"] = max(b3["max_abs_err"], meshes["b3"]["max_abs_err"])
    b4["max_abs_err"] = max(b4["max_abs_err"], meshes["b4"]["max_abs_err"])
    log(f"[kernels] B2 launches: {b2_train} on the train path, {b2_render} "
        f"in external-hit mode on the cornell render path, {b2_pot_render} "
        f"on the teapot render path, {b2_geom} on the geometry train path, "
        f"{b2_cornell} on the cornell train path, {scan['counts']['B2']} "
        f"and {scan_tri['counts']['B2']} on the scan ball_scenes and "
        f"cornell_boxes paths, {resumable['counts']['B2']} on the "
        f"resumable path, {scan_train['counts']['B2']} on the scan train "
        f"path; B3 launches {b3_cornell} on the cornell render path, "
        f"{b3_train} on the cornell train path, {b3_parity} on the cornell "
        f"parity render path, {scan_tri['counts']['B3']} on the scan "
        f"cornell_boxes path and {b3_a7} on the tiled Cornell paths; B2 ms "
        f"per launch "
        f"{b2['ms']} (train state, 16,384 lanes), {b2_ext['ms']} (cornell external hit, "
        f"65,536 lanes), {b2_ct['ms']} (cornell train state, external hit, "
        f"16,384 lanes; plain {b2_ct['plain_ms']}, bound "
        f"{b2_ct['bound_ms']}), {b2_pot['ms']} (teapot: specular and media, "
        f"65,536 lanes); B3 ms per launch {b3['ms']} (cornell render "
        f"wavefront, 65,536 lanes), {b3_ct['ms']} (cornell train state, "
        f"16,384 lanes; plain {b3_ct['plain_ms']}, bound "
        f"{b3_ct['bound_ms']}); B4 {b4['ms']} ms against B3 {b4['b3_ms']} "
        f"ms on the teapot's wavefront after three bounces")

    # the film and material sums: phases 4, 6 and 9, and every path of
    # phases 24-38 (each read from counts set to 0 just before it)
    film = {"name": "film_sum", "route": "cuda",
            "source": "srt_tpu_torch/csrc/film_sum.cu",
            "replaces": "srt_tpu/render/regen.py:117",
            "launches": film_main + film_tri + sum(
                p["launches"].get("film_sum", 0) for p in new_paths),
            **sums["film"], "max_abs_err": sums["film_err"]}
    seg = {"name": "segment_sum", "route": "cuda",
           "source": "srt_tpu_torch/csrc/segment_sum.cu",
           "replaces": "srt_tpu/pallas/bounce_bwd.py:308-315",
           "launches": sums_train + sum(
               p["launches"].get("segment_sum", 0) for p in new_paths),
           **sums["sums"][SUM_LANES[-1]]}
    seg["max_abs_err"] = max(c["max_abs_err"] for c in sums["sums"].values())
    for kern in (film, seg):
        if not kern["launches"]:
            raise AssertionError(f"{kern['name']}: no launch on the paths")
    log(f"[kernels] film_sum launches: {film_main} on the ball_scenes render "
        f"path, {film_tri} on the cornell render path, {film['launches']} in "
        f"all; ms on cornell_boxes' per-bounce flush {sums['film_tri']['ms']}"
        f" (index_add_ {sums['film_tri']['library_ms']}), on the {DEEP_SPP}"
        f"-spp flushes "
        f"{json.dumps({a: c['ms'] for a, c in sums['film_deep'].items()})} "
        f"(index_add_ "
        f"{json.dumps({a: c['library_ms'] for a, c in sums['film_deep'].items()})}"
        f"); the largest |kernel - plain| of the film {sums['film_err']}; "
        f"segment_sum "
        f"launches {sums_train} on the train path, {seg['launches']} in all; "
        f"ms by lanes {json.dumps({n: c['ms'] for n, c in sums['sums'].items()})}"
        f" (index_add_ "
        f"{json.dumps({n: c['library_ms'] for n, c in sums['sums'].items()})}"
        f"); the geometry step's gradient "
        f"{'repeats' if sums['geom_same'] else 'does not repeat'} to the bit")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in (b1, b2, b2_parity, b3, b4,
                                               b5, b6, film, seg)]}),
          flush=True)
    print(json.dumps({"paths": new_paths}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
