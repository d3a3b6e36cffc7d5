"""``BENCHMARK.json`` against the benchmark's contract, and every name it
gives found as a file: configurations, traffic mixes, limits, metric
readers."""
from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_lines(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_configurations_load_by_name():
    for c in BENCH["configs"]:
        path = os.path.join(spec.ROOT, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        arrays, cam = spec.Cell.from_parts(
            "x", {"chips": 1}, cfg, {}, {}, [], []).scene()
        assert arrays["sph_radius"].shape[0] + arrays["tri_p0"].shape[0] \
            > 100
        assert set(cam) >= {"origin", "lower_left"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_load_by_name(cell):
    c = spec.Cell(cell)
    assert c.chips == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert c.traffic["entry"] in ("render_regen", "render", "train_step")
    for m in c.per_layer:
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert moved and cell in moved[0].get("workloads", [cell])
    assert set(c.limits) <= {"median_gap", "p99_gap", "moved_share",
                             "sign_skew", "off_share", "mean_gap", "max_gap",
                             "loss_gap", "grad_gap", "step_gap",
                             "step_gap_median"}


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_load_by_name(metric):
    m = [e for e in BENCH["per_layer"] if e["name"] == metric][0]
    assert m["source"] in SOURCES
    read = spec.reader(metric)
    # a reader that finds nothing of its kind returns nothing
    assert read({"kind": "nothing"}) is None
    if "roofline" in metric:
        assert metric.endswith("_roofline") and m["unit"] == "%"
