"""A run of each cell, small and on the CPU (the look for a card
skipped), comes out ``correct``; with each fault the cell can have planted
under the timed path it comes out not correct."""
from __future__ import annotations

import json
import time
import warnings

import pytest

from _cells import small_cell
from benchmark import faults, run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CASES = ([(c, None) for c in CELLS]
         + [(c, f) for c in CELLS for f in
            (faults.TRAIN_FAULTS if spec.Cell(c).traffic["entry"]
             == "train_step" else faults.RENDER_FAULTS)])


def run_cell(cell, capsys) -> dict:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = run.main(["--workload", cell.name, "--seed", "3000000029",
                       "--seconds", "0.1", "--trace", "0"], cell=cell,
                      device="cpu", t_start=time.time())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_fault_is_caught(name, fault, capsys):
    cell = small_cell(name)
    assert all(v is not None for v in cell.limits.values())
    if fault is None:
        out = run_cell(cell, capsys)
        assert out["correct"] is True
        assert list(out)[-1] == "check"
        assert {m["name"] for m in cell.end_to_end} == set(out["metrics"])
        return
    with faults.planted(fault, cell.traffic["entry"]):
        out = run_cell(cell, capsys)
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reaches_its_end(name, capsys):
    """The ``--trace 1`` path on the CPU: the profiler sees no device, so
    every reader of the device trace finds nothing and returns nothing
    (the host-clock walls, the backward's and the steps', are still read),
    and the line still carries the trace's keys and the check."""
    cell = small_cell(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = run.main(["--workload", name, "--seed", "3000000031",
                       "--seconds", "0.1", "--trace", "1"], cell=cell,
                      device="cpu", t_start=time.time())
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    assert set(out["metrics"]) <= {"train_bwd_ms", "step_p95_ms.train"}
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "check"
