"""The teapot scene's configuration: its frozen generator gives the
arrays of the port's library scene (the triangles as a soup, in the order
added, where the library stores them in BVH order), imports nothing of
the program, and its cell runs small on the CPU through the two-level
walk and passes its check; B4's two readers and the work they count."""
from __future__ import annotations

import json
import time
import warnings

import numpy as np
import pytest

from _cells import small_cell
from benchmark import run, spec, work_tris
from benchmark.scenes import teapot_scene
from benchmark.trace import DeviceTrace
from benchmark.tests._library import library_arrays
from benchmark.tests.test_harness_imports import modules_after

TRI = ("tri_p0", "tri_p1", "tri_p2", "tri_uv", "tri_n", "tri_mat")


def _rows(arrays: dict) -> np.ndarray:
    """Each triangle as one row of its corners, uvs, normals and material
    (float32 bits), sorted."""
    cols = [np.ascontiguousarray(arrays[k]).reshape(len(arrays["tri_p0"]), -1)
            .view(np.int32) for k in TRI]
    rows = np.concatenate(cols, axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("divs", [4, 100])
def test_generator_equals_library(divs):
    arrays, cam = teapot_scene.make(divs=divs)
    lib, lib_cam = library_arrays("teapot_scene", divs=divs)
    assert len(arrays["tri_p0"]) == len(lib["tri_p0"]) == (
        1_278_400 if divs == 100 else 1_984)
    assert not any(k.startswith(("bvh_", "top_", "cl_")) for k in arrays)
    assert np.array_equal(_rows(arrays), _rows(lib))
    for k, v in arrays.items():
        if k in TRI:
            continue
        w = lib.get(k)
        if v is None or w is None:
            assert v is None and w is None, k
            continue
        assert v.dtype == w.dtype and v.shape == w.shape, k
        assert np.array_equal(v, w), k
    assert set(lib) - set(arrays) <= {
        k for k in lib if k.startswith(("bvh_", "top_", "cl_"))}
    for k, v in lib_cam.items():
        assert np.array_equal(cam[k], v), k


def test_generator_imports_nothing_of_the_program():
    mods = modules_after("import benchmark.scenes.teapot_scene, "
                         "benchmark.work_tris\n"
                         "from benchmark.scenes import teapot_scene\n"
                         "teapot_scene.make(divs=2)")
    assert not mods & {"srt_tpu_torch", "srt_tpu", "jax", "jaxlib"}


def test_small_cell_runs_the_two_level_walk(capsys):
    """The cell at a few pixels on the CPU, the full teapots: the route
    takes B2 and the two-level walk, and the check passes."""
    cell = small_cell("teapot_scan")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = run.main(["--workload", "teapot_scan", "--seed", "3000000041",
                       "--seconds", "0.1", "--trace", "0"], cell=cell,
                      device="cpu", t_start=time.time())
    assert rc == 0
    out, err = capsys.readouterr()
    assert "bounce B2, walk B4" in err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"scan_rays_per_s", "setup_s"}


def rec(name, t0, t1, parent=None, call=5, **attrs):
    return dict(name=name, t0=t0, t1=t1, parent=parent, call=call,
                read=False, attrs=attrs)


#: a scan render in the window: two bounces of B4 then B2, a B2 with no
#: B4 before it (a chunk without triangles walked), and a call before the
#: window
RECS = [rec("render", 100, 900, call=4),
        rec("B4", 200, 300, parent=0, call=4, lanes=100, nodes=9, tests=9),
        rec("render", 1100, 9900),                                  # 2
        rec("bounces", 1200, 9000, parent=2),                       # 3
        rec("B4", 1300, 1400, parent=3, lanes=100, nodes=700, tests=300),
        rec("B2", 1400, 1500, parent=3, lanes=100, live=60),
        rec("B4", 1600, 1700, parent=3, lanes=100, nodes=500, tests=100),
        rec("B2", 1700, 1800, parent=3, lanes=100, live=20),
        rec("B2", 1900, 2000, parent=3, lanes=100, live=50)]
OPS = [("intersect_big_kernel<true>", 1300, 1400),
       ("intersect_big_kernel<true>", 1600, 1700),
       ("bounce_kernel<false, true, true, false, 1>", 1400, 1500)]


def ctx_of(recs, monkeypatch, ops=OPS):
    from srt_tpu_torch import trace as tracer
    monkeypatch.setattr(tracer, "records", lambda: recs)
    return {"kind": "render",
            "trace": DeviceTrace(list(ops), [("render", 1000, 10000)], 1.0)}


def test_b4_readers_on_a_recorded_trace(monkeypatch):
    ctx = ctx_of(RECS, monkeypatch)
    # the window's two launches took 200 lanes and tested 400 triangles
    assert spec.reader("b4_tests_per_lane")(ctx) == pytest.approx(2.0)
    # 80 live lanes after the two launches, over 200 ns of B4
    least, _ = work_tris.b4(lanes=80, launches=2)
    assert spec.reader("b4_roofline")(ctx) == pytest.approx(
        100.0 * least / 200e-9)


def test_b4_readers_find_nothing(monkeypatch):
    """No device operation, no B4 kernel, no B4 counter (a walk of
    another kind, or a program without them), nothing recorded: None."""
    no_counts = [dict(r, attrs={k: v for k, v in r["attrs"].items()
                                if k not in ("nodes", "tests")})
                 for r in RECS]
    for name in ("b4_roofline", "b4_tests_per_lane"):
        read = spec.reader(name)
        assert read({"kind": "nothing"}) is None
        assert read(ctx_of(RECS, monkeypatch, ops=[])) is None
        assert read(ctx_of(RECS[:2], monkeypatch)) is None
        assert read(ctx_of([], monkeypatch)) is None
    assert spec.reader("b4_tests_per_lane")(
        ctx_of(no_counts, monkeypatch)) is None
    assert spec.reader("b4_roofline")(ctx_of(
        RECS, monkeypatch, ops=OPS[2:])) is None


def test_b4_work_hand_count():
    t, by = work_tris.b4(lanes=1000, launches=4)
    assert by == "bytes"
    assert t == pytest.approx((1000 * 40 + 4 * 32) / 3.35e12)
    assert 1000 * 28 / 67e12 < t
