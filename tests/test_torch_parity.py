"""The reference-parity estimator's pieces against the JAX package's, and
its gates and golden tool (``test_torch_parity_bounce.py``,
``_no_stale.py``, ``_tris.py`` and ``_image.py`` hold the bounce and the
images).

* The reference's broken Erf, within 1e-6.
* ``sample_bsdf``, ``bsdf_pdf`` and ``bsdf_weight`` under parity on
  seeded lanes of two anisotropic Beckmann materials, Oren–Nayar and
  Lambertian, a third of them backfacing and a third grazing, where the
  raw-normal frame is not the face frame: every lane within rtol 1e-5 and
  atol 1e-6 of JAX's functions run op by op (no multiply-add contraction
  on either side, ROADMAP C5).
* The gates: what parity needs that is not ported raises, naming its
  ROADMAP item; B1 and B5 refuse parity, as JAX's gates do.
* The golden tool: the PNG reader against Pillow, ``golden_psnr`` against
  JAX's, and ``python -m srt_tpu_torch.golden`` on the CPU.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from srt_tpu.core.approx import erf_reference_buggy as jax_erf_buggy
from srt_tpu.materials import materials as jmats
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu.utils.compare import golden_psnr as jax_golden_psnr
from srt_tpu_torch import (RenderConfig, convert, get_scene,
                           make_train_step, render, render_regen)
from srt_tpu_torch import golden
from srt_tpu_torch.core.approx import erf_reference_buggy
from srt_tpu_torch.core.vecmath import to_local
from srt_tpu_torch.io.image import read_image, read_png, read_ppm, write_ppm
from srt_tpu_torch.kernels import launch_counts
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.materials import materials as mats
from srt_tpu_torch.render import film, regen_scan
from srt_tpu_torch.render.api import scene_flags
from srt_tpu_torch.scene.ir import SceneFlags, require_covered
from srt_tpu_torch.utils.compare import golden_psnr

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_erf_reference_buggy_matches_jax():
    r = np.random.default_rng(0)
    x = np.concatenate([[0.0, -0.0, 1e-8, -1e-8, 3.5, -3.5, 9.0, -9.0],
                        r.uniform(-5.0, 5.0, 4000),
                        np.linspace(-3.0, 3.0, 601)]).astype(np.float32)
    want = np.asarray(jax_erf_buggy(x))
    got = erf_reference_buggy(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # not erf: the exponential is added (Erf(0.29) ~ 1.178)
    assert got[np.argmin(np.abs(x - 0.29))] > 1.1


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _material_lanes(n: int = 6000):
    """Two anisotropic Beckmann materials, Oren–Nayar and Lambertian in
    both packages, and seeded lanes: the material, the stored normal, the
    ray direction (a third front hits, a third backfacing, a third within
    0.05 of grazing), two uniforms and a second direction."""
    b = JaxSceneBuilder()
    ms = [b.beckmann(b.constant((0.9, 0.6, 0.3)), 0.3, 0.05),
          b.beckmann(b.constant((0.5, 0.6, 0.7)), 0.02, 0.6),
          b.oren_nayar(b.constant((0.5, 0.5, 0.5)), 20.0),
          b.lambertian(b.constant((0.2, 0.7, 0.4)))]
    for i, m in enumerate(ms):
        b.sphere((3.0 * i, 0.0, 0.0), 1.0, m)
    scene_j = b.build()
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    r = np.random.default_rng(0)
    mat = r.integers(0, 4, n).astype(np.int32)
    normal = _unit(r.normal(size=(n, 3)))
    d = _unit(r.normal(size=(n, 3)))
    kind = np.arange(n) % 3
    cos = (d * normal).sum(1)
    flip = ((kind == 0) & (cos > 0)) | ((kind == 1) & (cos < 0))
    d = np.where(flip[:, None], -d, d)
    g = kind == 2
    tang = _unit(d[g] - (d[g] * normal[g]).sum(1, keepdims=True) * normal[g])
    tilt = r.uniform(-0.05, 0.05, int(g.sum())).astype(np.float32)[:, None]
    d[g] = _unit(tang + tilt * normal[g])
    u1, u2 = r.uniform(size=(2, n)).astype(np.float32)
    other = _unit(r.normal(size=(n, 3)))
    return scene_j, scene, dict(mat=mat, normal=normal, d=d, u1=u1, u2=u2,
                                other=other, kind=kind)


def test_parity_materials_match_jax(flush_denormals):
    scene_j, scene, x = _material_lanes()
    flags_j = JaxSceneFlags.of(scene_j)._replace(ref_parity=True)
    flags = SceneFlags.of(scene)._replace(ref_parity=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    mat = t["mat"].long()
    basis = mats.face_basis(t["normal"], t["d"])
    wo = to_local(basis, -t["d"])
    raw = mats.raw_frame(t["normal"], t["d"])
    n = len(x["mat"])
    uv, p = np.zeros((n, 2), np.float32), np.zeros((n, 3), np.float32)
    with jax.disable_jit():
        want_wi = np.asarray(jmats.sample_bsdf(
            scene_j, x["mat"], x["normal"], x["d"], x["u1"], x["u2"],
            flags_j))
        wi = np.concatenate([want_wi[:n // 2], x["other"][n // 2:]])
        want_pdf = np.asarray(jmats.bsdf_pdf(scene_j, x["mat"], x["normal"],
                                             x["d"], wi, flags_j))
        want_w = np.asarray(jmats.bsdf_weight(
            scene_j, x["mat"], uv, p, x["normal"], x["d"], wi, flags_j))
    got_wi = mats.sample_bsdf(scene, mat, basis, wo, t["u1"], t["u2"],
                              flags, raw).numpy()
    got_pdf = mats.bsdf_pdf(scene, mat, basis, wo, torch.from_numpy(wi),
                            flags, raw).numpy()
    got_w = mats.bsdf_weight(scene, mat, torch.from_numpy(uv),
                             torch.from_numpy(p), basis, wo,
                             torch.from_numpy(wi), flags, raw).numpy()
    for got, want in ((got_wi, want_wi), (got_pdf, want_pdf),
                      (got_w, want_w)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the raw frame matters: on backfacing Beckmann lanes the parity
    # sample is not the default estimator's, and parity's pdf differs
    default = mats.sample_bsdf(scene, mat, basis, wo, t["u1"], t["u2"],
                               flags._replace(ref_parity=False)).numpy()
    back_beck = (x["kind"] == 1) & (x["mat"] < 2)
    moved = np.abs(default - got_wi).max(1) > 1e-3
    assert moved[back_beck].mean() > 0.5
    assert (want_pdf == 0).any() and (want_pdf > 0).any()


def test_require_covered_accepts_parity():
    scene, _, _ = get_scene("ball_scenes", device="cpu")
    flags = scene_flags(scene, RenderConfig(ref_parity=True,
                                            parity_no_stale=True))
    assert flags.ref_parity and flags.parity_no_stale
    require_covered(scene, flags)
    assert not scene_flags(scene, RenderConfig()).ref_parity


def test_scan_engine_modes_raise_a6(tmp_path):
    """The scan engine's modes, which raised naming A6 until it was
    ported, render: ``seq_stale`` through ``render_regen`` is the default
    regeneration render (JAX's regen ignores it too), and the golden tool
    takes the scan engine for ``--engine scan`` and ``--seq-stale``, as
    ``tools/golden.py:80`` chooses, its image the library's."""
    scene, cam, _ = get_scene("ball_scenes", device="cpu")
    cfg = RenderConfig(width=4, height=4, spp=1, ref_parity=True)
    assert torch.equal(render_regen(scene, cam, dataclasses.replace(
        cfg, seq_stale=True)), render_regen(scene, cam, cfg))
    tri, tri_cam, _ = get_scene("cornell_boxes", device="cpu")
    for extra, cfg in (
            (["--engine", "scan"], RenderConfig(width=8, height=8, spp=1)),
            (["--seq-stale", "--ref-parity"],
             RenderConfig(width=8, height=8, spp=1, ref_parity=True,
                          seq_stale=True))):
        args = golden.parse_args(["--scene", "cornell_boxes", "--size", "8",
                                  "--spp", "1", "--device", "cpu",
                                  "--out-dir", str(tmp_path)] + extra)
        out = golden.run(args)
        want = film.tonemap(render(tri, tri_cam, dataclasses.replace(
            cfg, max_depth=50)))
        np.testing.assert_array_equal(
            read_ppm(out["ours"]),
            np.clip(255.99 * want.numpy(), 0, 255).astype(np.uint8))


def test_regen_kernel_refuses_parity():
    """B1 does not run parity, as ``fused_regen_available`` refuses it;
    the engine takes the per-bounce loop (B2) for parity instead."""
    scene, cam, _ = get_scene("ball_scenes", device="cpu")
    flags = scene_flags(scene, RenderConfig(ref_parity=True))
    spec = kb.RegenSpec(width=8, height=8, spp=1, max_depth=4,
                        rr_start=1 << 30, pdf_floor=1e-9, seed=0)
    inp = kb.RegenInputs(scene, flags, cam, torch.zeros((1, 2)))
    st = kb.new_wavefront(64, "cpu")
    with pytest.raises(ValueError, match="parity"):
        kb.regen_bounce(inp, st, spec)
    with pytest.raises(ValueError, match="parity"):
        kb.regen_args(inp, st, spec)
    launches = launch_counts()["B1"]
    img = render_regen(scene, cam, RenderConfig(width=8, height=8, spp=1,
                                                max_depth=4, ref_parity=True))
    assert launch_counts()["B1"] == launches and torch.isfinite(img).all()


def test_train_step_never_sets_parity():
    """The train step's flags are the scene's (parity off), as JAX's
    ``make_train_step`` never sets it; B5 refuses parity flags (JAX's
    backward gate excludes it), so a caller's parity bounce takes the
    hybrid."""
    scene, cam, _ = get_scene("ball_scenes", device="cpu")
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           width=4, height=4, spp=1, max_depth=2,
                           device="cpu")
    assert not step.flags.ref_parity and not step.flags.parity_no_stale
    parity = step.flags._replace(ref_parity=True)
    assert kbb.bwd_kernel_available(scene, step.flags)
    assert not kbb.bwd_kernel_available(scene, parity)
    with pytest.raises(NotImplementedError, match="parity"):
        kbb.require_bwd_kernel(scene, parity)


def test_trace_queue_carries_stale(monkeypatch):
    """Under parity the train engine's wavefront carries the ``stale``
    plane from bounce to bounce and across regeneration, on the plain
    path, as ``srt_tpu/render/regen_scan.py:72-141`` does."""
    scene, cam, _ = get_scene("ball_scenes", device="cpu")
    flags = SceneFlags.of(scene)._replace(ref_parity=True)
    tables = kb.build_tables(scene, flags)
    seen = []
    orig = regen_scan.bounce_step_auto

    def spy(scene, flags, tables, state, spec, walk=None):
        seen.append(state["stale"].clone())
        out = orig(scene, flags, tables, state, spec, walk)
        assert out["stale"].shape == state["alive"].shape
        return out

    monkeypatch.setattr(regen_scan, "bounce_step_auto", spy)
    n = 96
    r = np.random.default_rng(0)
    o = torch.tensor([[0.0, 3.0, -12.0]]).repeat(n, 1)
    d = torch.from_numpy(_unit(r.normal(size=(n, 3)) * [0.2, 0.2, 1.0]
                               + [0.0, -0.1, 1.0]))
    rays = (o, d, torch.zeros(n))
    salts = torch.from_numpy(r.integers(0, 2 ** 31, n).astype(np.int32))
    out, started = regen_scan.trace_queue(
        scene, flags, tables, rays, salts, n_steps=6, wavefront=32,
        spec=kb.StepSpec(max_depth=4))
    assert len(seen) == 6 and torch.equal(seen[0], torch.zeros(32))
    assert all((s != 0).any() for s in seen[1:])
    assert torch.isfinite(out).all() and int(started.sum()) > 32


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "goldens", "*.png"))), ids=os.path.basename)
def test_png_reader_equals_pillow(path):
    pil = pytest.importorskip("PIL.Image")
    with pil.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = read_png(path)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(read_image(path), want)


def test_film_matches_jax():
    from srt_tpu.render import film as jfilm
    from srt_tpu_torch.render import film
    lin = np.random.default_rng(1).uniform(-0.5, 2.0, (33, 3)) \
        .astype(np.float32)
    tm = film.tonemap(torch.from_numpy(lin))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jfilm.tonemap(lin)))
    np.testing.assert_array_equal(film.to_uint8(tm).numpy(),
                                  np.asarray(jfilm.to_uint8(tm.numpy())))


def test_golden_psnr_matches_jax():
    r = np.random.default_rng(0)
    render01 = r.uniform(size=(40, 36, 3)).astype(np.float32)
    gold = r.integers(0, 256, (40, 36, 3)).astype(np.uint8)
    for ds in (1, 4):
        assert golden_psnr(render01, gold, ds) \
            == jax_golden_psnr(render01, gold, ds)


def test_golden_tool_on_the_cpu(tmp_path):
    """``python -m srt_tpu_torch.golden`` at 16x16, 1 spp, depth 4 on the
    CPU writes its PPM and prints one JSON line with ``tools/golden.py``'s
    keys, the comparison's included (against a PPM golden)."""
    gold = tmp_path / "gold.ppm"
    write_ppm(str(gold), np.full((16, 16, 3), 0.5, np.float32))
    proc = subprocess.run(
        [sys.executable, "-m", "srt_tpu_torch.golden", "--scene",
         "cornell_boxes", "--size", "16", "--spp", "1", "--max-depth", "4",
         "--device", "cpu", "--out-dir", str(tmp_path), "--golden",
         str(gold), "--ref-parity"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"scene", "spp", "size", "pdf_floor", "max_depth",
                        "wall_s", "ours", "golden", "psnr_db", "mean_ours",
                        "mean_golden", "psnr_ds_db", "downsample"}
    ours = read_image(rec["ours"])
    assert ours.shape == (16, 16, 3) and rec["mean_golden"] == 127.0
    assert np.isfinite(rec["psnr_db"])
