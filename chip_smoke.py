"""Smoke run of the PyTorch/CUDA port (``srt_tpu_torch``) on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py [--ppm OUT.ppm]`` from the repository root.
Needs one CUDA device; imports neither JAX nor ``srt_tpu``. Phases, each
of which raises on failure:

1. the device: its name and power limit from ``nvidia-smi``;
2. build: ``nvcc`` compiles each ``srt_tpu_torch/csrc/*.cu`` for
   ``sm_90a``, all at once, and links one library;
3. the regeneration kernel (B1) against its plain PyTorch version on the
   card: one step of a mid-flight 65,536-lane ball_scenes wavefront lane
   by lane, a 64x64, 4 spp, depth 8 image, and the time per bounce of each;
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
   and no B3 or B1.

Prints one JSON line about the kernels, then the ``nvidia-smi`` line, then
``{"ok": true, "device": {...}}`` as the last line.
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
# shade<Dual<7>>: each float operation becomes a value and 7 tangents,
# 15 operations on average (a product takes 1 + 3*7, a sum 1 + 7); the
# backward kernel runs two such passes
OPS_DUAL = 15
BWD_PASSES = 2


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
    # mid-flight: the work cursor at mid-image (the spheres), three plain
    # bounces, then a random half of the lanes marked finished
    mid = kb.new_wavefront(LANES, dev)
    mid["cursor"].fill_(spec.total_work // 2)
    for _ in range(3):
        kb.regen_bounce_reference(inp, mid, spec)
    half = torch.from_numpy(np.random.default_rng(0).random(LANES) < 0.5)
    mid["alive"][half.to(dev)] = 0
    mid["dead"].copy_(kb.count_dead(mid["alive"]))
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
    kern_ms = [time_bounces(kb.regen_bounce, inp, mid, spec, 50)
               for _ in range(2)]
    plain_ms.append(time_bounces(kb.regen_bounce_reference, inp, mid,
                                 spec, 10))
    log(f"[bounce] ms per bounce at {LANES} lanes: kernel {kern_ms}, "
        f"plain {plain_ms}")

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


def train_state(scene, cam, flags, tables, spec, dev) -> dict:
    """A mid-flight 16,384-lane wavefront of the train engine: lanes start
    from ``render_pixels``' camera rays (256x256, 4 spp, seed 0, taken in
    a seeded order), take three plain bounces, and a lane that ends is
    refilled from the ray queue, as the engine does; then a seeded half of
    the lanes is marked dead."""
    import numpy as np
    import torch

    from srt_tpu_torch.diff.inverse import camera_rays
    from srt_tpu_torch.kernels import bounce as kb

    w, spp = TRAIN["width"], TRAIN["spp"]
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
        if i < 3:
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
    fargs, _ = kb.fwd_args(scene, tables, st, spec)
    bargs, _ = kbb.bwd_args(scene, tables, st, ct, spec)
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
    bwd_bound = bound(n * (105 + 92), n_live * (
        sweep + BWD_PASSES * OPS_DUAL * OPS_SHADE))
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


def phase_train(scene, cam, dev) -> tuple[int, int]:
    """Phase 6: the train path; returns the B2 and B5 launches of the
    timed steps."""
    import numpy as np
    import torch

    from srt_tpu_torch import make_train_step
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.render.regen_scan import steps_for

    w, spp = TRAIN["width"], TRAIN["spp"]
    rays = w * w * spp
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           width=w, height=w, spp=spp,
                           max_depth=TRAIN["max_depth"], lr=TRAIN_LR,
                           engine_kw=TRAIN_ENGINE, device=dev)
    target = torch.full((w, w, 3), TRAIN_TARGET, device=dev)
    t0 = time.time()
    loss0 = float(step(target, 0))
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    kb.LAUNCHES_FWD = kbb.LAUNCHES_BWD = 0
    walls, losses = [], []
    for seed in range(1, TRAIN_STEPS + 1):
        t0 = time.time()
        loss = step(target, seed)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        losses.append(float(loss))
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
    import torch

    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.kernels.build import launch
    from srt_tpu_torch.scene.ir import SceneFlags
    from srt_tpu_torch.utils import contract

    st, inp, step, _ = tri_wavefront(scene, cam, dev)
    b3 = check_tri_kernel("cornell", scene, st["o"], st["d"])
    check_tri_kernel("final-ground", *ground_field(dev))

    flags, tables = SceneFlags.of(scene), inp.tables
    tri = ki.intersect_tris(scene, ki.pack_tables(scene), st["o"], st["d"])
    out_k = kb.bounce_fwd(scene, flags, tables, st, step, tri)
    out_p = kb.bounce_step_ref(scene, flags, tables["mat"], st, step, tri)
    torch.cuda.synchronize()
    if not torch.equal(out_k["depth"], out_p["depth"]):
        raise AssertionError("B2 external-hit depth differs")
    keys = ("alive", "d", "beta", "radiance")
    m = contract.check_bounce({k: out_p[k].cpu().numpy() for k in keys},
                              {k: out_k[k].cpu().numpy() for k in keys})
    n_live = int(st["alive"].sum())
    n_tri = int((st["alive"] & (tri[0] < 3e38)).sum())
    fargs, _ = kb.fwd_args(scene, tables, st, step, tri)
    kern_ms = [time_ms(lambda: launch("srt_bounce", fargs, dev), 200)
               for _ in range(2)]
    plain_ms = time_ms(lambda: kb.bounce_step_ref(
        scene, flags, tables["mat"], st, step, tri), 5)
    ms_bound, by = bound(LANES * (73 + 53), n_live * (
        scene.n_rects * OPS_RECT + OPS_SHADE) + n_tri * OPS_TRI_HIT)
    log(f"[bounce-ext] {LANES} lanes, {n_live} live, {n_tri} on a "
        f"triangle: depth exact, {json.dumps(m)}; ms per launch {kern_ms}, "
        f"plain {plain_ms:.3f}, bound {ms_bound:.6f} ({by})")
    b3.update(name="intersect_tris", route="cuda",
              source="srt_tpu_torch/csrc/intersect_tris.cu",
              replaces="srt_tpu/pallas/intersect.py:148", library_ms=None)
    return b3, {"max_abs_err": max(m[k]["max"] for k in keys[1:]),
                "ms": min(kern_ms)}


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
    fargs, _ = kb.fwd_args(scene, tables, st, step, tri)
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ppm", default=None,
                    help="also write the main-path image (sqrt gamma) here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

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
    b2["launches"] = b2_train + b2_render + b2_pot_render
    b2["max_abs_err"] = max(b2["max_abs_err"], b2_ext["max_abs_err"],
                            b2_pot["max_abs_err"])
    log(f"[kernels] B2 launches: {b2_train} on the train path, {b2_render} "
        f"in external-hit mode on the cornell render path, {b2_pot_render} "
        f"on the teapot render path; B2 ms per launch {b2['ms']} (train "
        f"state, 16,384 lanes), {b2_ext['ms']} (cornell external hit, "
        f"65,536 lanes), {b2_pot['ms']} (teapot: specular and media, 65,536 "
        f"lanes); B4 {b4['ms']} ms against B3 {b4['b3_ms']} ms on the "
        f"teapot's wavefront after three bounces")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in (b1, b2, b3, b4, b5)]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
