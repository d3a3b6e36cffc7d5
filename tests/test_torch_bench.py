"""The port's benchmark tools on the CPU, through the kernels' plain
versions: ``python -m srt_tpu_torch.bench`` and ``python -m
srt_tpu_torch.trainbench`` run in process (their ``main(argv)``) at a few
pixels, depth 3. The JSON line carries the keys of the repository's
``bench.py`` (``bench.py:164-182``, the side cell ``:186-204``, the matrix
``:206-305``) and of ``tools/trainbench.py`` (``:90-94``), plus
``backend``."""
from __future__ import annotations

import json
import os

import pytest
import torch

from srt_tpu_torch import bench, trainbench
from srt_tpu_torch.utils import cache

torch.set_num_threads(1)

#: the keys bench.py prints (bench.py:164-182)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "baseline_rays_per_sec", "scene", "engine", "engines",
              "config", "device", "wall_s", "warmup_s", "nan_pixels"}
#: a matrix scene's keys (bench.py:283-290)
MATRIX_KEYS = {"n_tris", "primary_rays_per_sec", "path_vertices_per_sec",
               "wall_s", "warmup_s", "nan_pixels", "mean"}
TINY = ["--device", "cpu", "--width", "8", "--spp", "1", "--max-depth", "3",
        "--min-seconds", "0"]


@pytest.fixture
def tiny_tri_cell(monkeypatch):
    # the side cell's 256x256x8 through the plain bounce on the CPU would
    # take a minute: the same cell at 8x8x1
    monkeypatch.setattr(bench, "TRI_CELL", dict(bench.TRI_CELL, width=8,
                                                spp=1))


def _line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return json.loads(out[0])


@pytest.mark.parametrize("scene", ["ball_scenes", "cornell_boxes"])
def test_bench_both_engines(scene, tiny_tri_cell, capsys):
    bench.main(TINY + ["--engine", "both", "--scene", scene,
                       "--sample-chunk", "1"])
    rec = _line(capsys)
    assert BENCH_KEYS | {"backend"} <= set(rec)
    assert rec["backend"] == "torch-cpu" and rec["device"] == "cpu"
    assert set(rec["engines"]) == set(rec["warmup_s"]) == {"regen", "scan"}
    best = min(rec["engines"], key=lambda e: rec["engines"][e]["wall_s"]
               / rec["engines"][e]["reps"])
    assert rec["engine"] == best
    assert rec["value"] == rec["engines"][best]["rays_per_sec"] > 0
    assert rec["nan_pixels"] == 0
    assert rec["config"] == {"width": 8, "height": 8, "spp": 1,
                             "max_depth": 3,
                             "reps": rec["engines"][best]["reps"]}
    if scene == "ball_scenes":
        assert rec["tri_scene"] == {
            "scene": "cornell_box", "width": 8, "spp": 1,
            "rays_per_sec": rec["tri_scene"]["rays_per_sec"],
            "nan_pixels": 0}
        assert rec["tri_scene"]["rays_per_sec"] > 0
    else:
        assert "tri_scene" not in rec


def test_bench_sample_chunk_reaches_the_scan_engine(monkeypatch, capsys):
    seen = []
    orig = bench.ENGINES["scan"]

    def scan(scene, camera, config, **kw):
        seen.append(config.sample_chunk)
        return orig(scene, camera, config, **kw)
    monkeypatch.setitem(bench.ENGINES, "scan", scan)
    bench.main(TINY + ["--engine", "scan", "--scene", "two_spheres",
                       "--sample-chunk", "3"])
    assert _line(capsys)["engines"].keys() == {"scan"}
    assert seen and set(seen) == {3}


def test_bench_matrix_and_artifact(monkeypatch, tmp_path, capsys):
    """Two asset-free scenes; ``--no-cache`` points the build directory at
    a temporary one of the process (restored after the test)."""
    monkeypatch.setattr(bench, "list_scenes",
                        lambda: ["two_spheres", "cornell_boxes"])
    monkeypatch.setattr(cache, "_dir", cache.build_dir())
    out = tmp_path / "matrix.json"
    bench.main(TINY + ["--scene", "two_spheres", "--matrix",
                       "--matrix-width", "8", "--matrix-spp", "1",
                       "--matrix-out", str(out), "--no-cache"])
    assert os.path.basename(cache.build_dir()).startswith(
        "srt_tpu_torch_build_")
    rec = _line(capsys)
    assert list(rec["matrix"]) == ["two_spheres", "cornell_boxes"]
    for name, entry in rec["matrix"].items():
        assert MATRIX_KEYS <= set(entry), name
        assert entry["nan_pixels"] == 0 and 0.0 < entry["mean"] < 1.0
        assert entry["path_vertices_per_sec"] >= entry["primary_rays_per_sec"]
    assert rec["matrix"]["cornell_boxes"]["n_tris"] == 24
    assert rec["matrix"]["two_spheres"]["n_tris"] == 0
    art = json.loads(out.read_text())
    assert {"what", "workload", "date", "scenes"} <= set(art)
    assert "cpu" in art["what"] and "TPU" not in art["what"]
    assert art["workload"] == {"width": 8, "height": 8, "spp": 1,
                               "max_depth": 3}
    # neither scene is in BASELINE_CPP.json: the port's rates alone
    assert art["scenes"] == {n: {
        "srt_tpu_rays_per_sec": e["primary_rays_per_sec"],
        "path_vertices_per_sec": e["path_vertices_per_sec"]}
        for n, e in rec["matrix"].items()}


def test_bench_matrix_joins_the_cpp_baseline(monkeypatch, tmp_path, capsys):
    """BASELINE_CPP.json names ``ball_orennayar``, the library
    ``ball_orennayar_scenes``: the C++ rate and the ratio are joined; the
    dome image the library replaced by its stand-in is reported."""
    monkeypatch.setattr(bench, "list_scenes",
                        lambda: ["ball_orennayar_scenes"])
    out = tmp_path / "matrix.json"
    bench.main(TINY + ["--scene", "two_spheres", "--matrix",
                       "--matrix-width", "8", "--matrix-spp", "1",
                       "--matrix-out", str(out)])
    entry = _line(capsys)["matrix"]["ball_orennayar_scenes"]
    assert entry["skipped_assets"] and MATRIX_KEYS <= set(entry)
    row = json.loads(out.read_text())["scenes"]["ball_orennayar_scenes"]
    assert row["cpp_rays_per_sec"] > 0
    assert row["vs_cpp"] == round(entry["primary_rays_per_sec"]
                                  / row["cpp_rays_per_sec"], 2)


def test_bench_raises_for_an_unknown_scene():
    with pytest.raises(KeyError):
        bench.main(TINY + ["--scene", "no_such_scene"])


def test_trainbench_prints_the_speedup(capsys):
    trainbench.main(["--device", "cpu", "--width", "8", "--spp", "1",
                     "--max-depth", "3", "--reps", "1", "--engines", "regen",
                     "scan"])
    rec = _line(capsys)
    assert set(rec["engines"]) == {"regen", "scan"}
    assert rec["speedup_regen_vs_scan"] == round(
        rec["engines"]["regen"]["rays_per_sec"]
        / rec["engines"]["scan"]["rays_per_sec"], 2)
    assert rec["backend"] == "torch-cpu"
