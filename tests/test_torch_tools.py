"""The port's counterparts of the JAX package's tools, against those tools
and against JAX: ``python -m srt_tpu_torch.dist.scaling``
(``tools/scaling.py``), ``.golden_avg`` (``tools/golden_avg.py``, run as
a subprocess on the same files), ``.regions`` (``tools/regions.py``'s
masks, imported by path) and ``.phases`` (``tools/phases.py``'s keys);
and ``io.assets.require_asset`` against JAX's.

The scaling sweep spawns its gloo processes itself, each joining through
a file in the test's ``tmp_path`` and all joined within the sweep's
``--timeout``; on the CPU it measures no scaling, only that the sweep
runs and that N processes give one process's image."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import srt_tpu.io.assets as jassets
from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu.dist import make_mesh as jax_make_mesh
from srt_tpu.dist import render_sharded as jax_render_sharded
from srt_tpu.scene.library import get_scene as jax_get_scene
from srt_tpu_torch import golden_avg, phases, regions
from srt_tpu_torch.dist import scaling
from srt_tpu_torch.io import assets
from srt_tpu_torch.io.image import write_png, write_ppm
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = dict(scene="cornell_boxes", width=16, spp=2, max_depth=3)


def _jax_tool(name: str):
    """``tools/<name>.py`` of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scaling_sweep_on_the_cpu(tmp_path):
    """``--devices 1 2`` over gloo: two processes give the one-process
    image to the bit, the first count's efficiency is 1, the keys are
    JAX's plus ``backend`` and ``cards``; the one-process image agrees
    with JAX's ``render_sharded`` on one device under the image
    contract."""
    out = scaling.run(scaling.parse_args(
        ["--scene", SWEEP["scene"], "--width", str(SWEEP["width"]),
         "--spp", str(SWEEP["spp"]), "--max-depth", str(SWEEP["max_depth"]),
         "--reps", "1", "--devices", "1", "2", "--device", "cpu",
         "--work-dir", str(tmp_path), "--timeout", "240"]))
    assert out["metric"] == "scaling_rays_per_sec"
    assert (out["backend"], out["cards"], out["platform"]) == ("gloo", 0,
                                                               "cpu")
    rows = out["devices"]
    assert sorted(rows) == [1, 2]
    assert set(rows[1]) == {"rays_per_sec", "wall_s", "efficiency_vs_linear"}
    assert set(rows[2]) == set(rows[1]) | {"bit_exact_vs_1dev"}
    assert rows[2]["bit_exact_vs_1dev"] is True
    assert rows[1]["efficiency_vs_linear"] == 1.0
    assert all(math.isfinite(r[k]) and r[k] > 0 for r in rows.values()
               for k in ("rays_per_sec", "wall_s", "efficiency_vs_linear"))
    json.dumps(out)
    scene_j, cam_j, _ = jax_get_scene(SWEEP["scene"], aspect=1.0)
    w = SWEEP["width"]
    want = np.asarray(jax_render_sharded(
        scene_j, cam_j, JaxRenderConfig(
            width=w, height=w, spp=SWEEP["spp"],
            max_depth=SWEEP["max_depth"], rr_start=1 << 30,
            sample_chunk=SWEEP["spp"]), jax_make_mesh(1)))
    contract.check_image(np.load(tmp_path / "img1.npy"), want)


def _chunks(tmp_path):
    """Three seeded 20x24 chunk PPMs and a seeded golden, PPM and PNG."""
    r = np.random.default_rng(15)
    base = r.uniform(0.1, 0.9, (20, 24, 3))
    for k in range(3):
        write_ppm(str(tmp_path / f"chunk_s{k}.ppm"),
                  np.clip(base + r.normal(0, 0.08, base.shape), 0, 1))
    gold = np.clip(base + r.normal(0, 0.02, base.shape), 0, 1)
    write_ppm(str(tmp_path / "golden.ppm"), gold)
    write_png(str(tmp_path / "golden.png"), gold)
    return str(tmp_path / "chunk_s*.ppm")


def test_golden_avg_matches_the_jax_tool(tmp_path):
    """The port's average of seeded chunks against ``tools/golden_avg.py``
    run as a subprocess on the same files: the same keys, the same PSNRs
    and means to 1e-6, the same averaged PPM; a PNG golden gives the same
    numbers as its PPM."""
    chunks = _chunks(tmp_path)
    args = ["--chunks", chunks, "--golden", str(tmp_path / "golden.ppm"),
            "--downsample", "2"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "golden_avg.py"), *args,
         "--out", str(tmp_path / "avg_jax.ppm")],
        capture_output=True, text=True, env=env, timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = golden_avg.run(golden_avg.parse_args(
        args + ["--out", str(tmp_path / "avg.ppm")]))
    assert set(got) == set(want) and got["n_chunks"] == 3
    for k in ("psnr_db", "psnr_ds_db", "mean_ours", "mean_golden"):
        assert math.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-6, k
    assert ((tmp_path / "avg.ppm").read_text()
            == (tmp_path / "avg_jax.ppm").read_text())
    png = golden_avg.run(golden_avg.parse_args(
        ["--chunks", chunks, "--golden", str(tmp_path / "golden.png"),
         "--downsample", "2"]))
    assert {k: png[k] for k in ("psnr_db", "psnr_ds_db")} == \
        {k: got[k] for k in ("psnr_db", "psnr_ds_db")}


@pytest.mark.parametrize("size", [37, 500])
def test_region_masks_equal_jax(size):
    """The floor, sky and soldier masks equal ``tools/regions.py``'s."""
    want = _jax_tool("regions").masks(size)
    got = regions.masks(size)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert all(m.any() for m in got)


def test_regions_reads_the_repository_golden(tmp_path):
    """The default golden is the repository's soldier PNG at 500^2; a
    render at another size is compared with none, one row a variant."""
    assert regions.GOLDEN == os.path.join(REPO, "goldens",
                                          "soldier_scene_500.png")
    out = regions.run(regions.parse_args(
        ["--spp", "1", "--size", "40", "--max-depth", "2", "--device",
         "cpu", "--variants", "ref", "rect", "--out-dir", str(tmp_path)]))
    assert "golden" not in out
    for v in ("ref", "rect"):
        assert os.path.exists(out[v]["ppm"])
        assert all(np.isfinite(out[v][f"{k}_rgb"]).all()
                   for k in ("floor", "sky", "soldier"))


#: the keys ``tools/phases.py`` prints, without and with ``--loop``
JAX_PHASE_KEYS = {"metric", "scene", "lanes", "device", "raygen_s",
                  "intersect_s", "bounce_s",
                  "shade_s(est bounce - intersect)", "lanes_per_sec_bounce"}
JAX_LOOP_KEYS = {"loop_k", "loop_intersect_s", "loop_bounce_s",
                 "loop_shade_s", "loop_lanes_per_sec_bounce",
                 "loop_sample_bsdf_s", "loop_bsdf_pdf_s",
                 "loop_bsdf_weight_s", "loop_lights_s", "loop_rng12_s"}


@pytest.mark.parametrize("scene,loop", [("ball_scenes", 2),
                                        ("cornell_boxes", 0)])
def test_phases_on_the_cpu(scene, loop):
    """1,024 lanes: JAX's keys (and the loop's under ``--loop``) and the
    route's, each time finite and positive where JAX's is a time."""
    out = phases.run(phases.parse_args(
        ["--scene", scene, "--lanes", "1024", "--reps", "1", "--loop",
         str(loop), "--device", "cpu"]))
    want = JAX_PHASE_KEYS | (JAX_LOOP_KEYS if loop else set())
    assert set(out) == want | {"route"}
    for k in want - {"metric", "scene", "device", "lanes", "loop_k",
                     "shade_s(est bounce - intersect)", "loop_shade_s"}:
        assert math.isfinite(out[k]) and out[k] > 0, k
    route = out["route"]
    assert route["bounce"] == "B2"
    assert route["walk"] == (None if scene == "ball_scenes" else "B3")
    assert ("walk_s" in route) == (scene == "cornell_boxes")
    assert math.isfinite(route["step_s"]) and route["step_s"] > 0
    json.dumps(out)


def test_require_asset_raises_as_jax(tmp_path, monkeypatch):
    """A missing asset raises ``FileNotFoundError`` naming it in both
    packages; a present one resolves to the same path."""
    monkeypatch.setenv("SRT_ASSETS", str(tmp_path))
    monkeypatch.setattr(jassets, "ASSET_ROOTS", [str(tmp_path)])
    for fn in (assets.require_asset, jassets.require_asset):
        with pytest.raises(FileNotFoundError, match="models/none.ply"):
            fn("models/none.ply")
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "one.ply").write_text("ply\n")
    assert (assets.require_asset("models\\one.ply")
            == jassets.require_asset("models\\one.ply")
            == str(tmp_path / "models" / "one.ply"))
