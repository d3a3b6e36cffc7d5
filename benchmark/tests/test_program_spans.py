"""``benchmark/program_spans.py`` and its readers on synthetic device
operations and program records (the tracer's readout replaced), on the
CPU: overlapping operations make no hole; a hole takes the innermost
program span open when it began (a read, ``setup``, ``rays``), or none
outside every span; records outside the harness's window are left out;
the live-lane and backward readers sum the counters of the window's
calls."""
from __future__ import annotations

import pytest

from benchmark import program_spans, spec
from benchmark.trace import DeviceTrace
from srt_tpu_torch import trace as tracer

MS = 1e-6            # ms a ns


def rec(name, t0, t1, parent=None, call=5, read=False, **attrs):
    return dict(name=name, t0=t0, t1=t1, parent=parent, call=call,
                read=read, attrs=attrs)


#: a render_regen call (5) inside the harness's window [1000, 11000], and
#: one (4) before it
REGEN = [
    rec("render_regen", 100, 900, call=4, path_vertices=900),
    rec("B1", 200, 300, parent=0, call=4, lanes=1000),
    rec("render_regen", 1100, 9900, path_vertices=150),    # 2
    rec("setup", 1200, 2000, parent=2),                    # 3
    rec("tables", 1300, 1500, parent=3, read=True),
    rec("B1", 2100, 2200, parent=2, lanes=100),
    rec("check", 3000, 3500, parent=2, read=True),
    rec("B1", 4000, 4100, parent=2, lanes=100),
    rec("finish", 9000, 9800, parent=2),
]
HARNESS = [("render_regen", 1000, 10000), ("readback", 10000, 11000)]
#: two overlapping operations, then holes opening in ``tables`` (80 ns),
#: in ``setup`` (100), in ``check`` (100) and after the call (150), and
#: one before the window, in call 4 (50)
OPS = [("k", 400, 450), ("k", 500, 1310), ("k", 1250, 1320),
       ("k", 1400, 1700), ("k", 1800, 3200), ("k", 3300, 9950),
       ("k", 10100, 10500)]


def ctx_of(recs, ops=OPS, spans=HARNESS, monkeypatch=None, kind="render"):
    monkeypatch.setattr(tracer, "records", lambda: recs)
    return {"kind": kind, "trace": DeviceTrace(list(ops), list(spans), 1.0)}


def test_holes_of_the_union():
    assert program_spans.holes(OPS) == [
        (450, 500), (1320, 1400), (1700, 1800), (3200, 3300), (9950, 10100)]
    # nested and overlapping operations leave no hole
    assert program_spans.holes([("a", 0, 10), ("b", 2, 5), ("c", 9, 20),
                                ("d", 20, 30)]) == []


def test_holes_take_the_innermost_span(monkeypatch):
    win = program_spans.window(ctx_of(REGEN, monkeypatch=monkeypatch))
    assert [r["call"] for r in win.entries] == [5]
    got = [(ns, None if r is None else r["name"]) for ns, r in win.gaps]
    # the hole before the window opens in call 4, which is left out
    assert got == [(50, None), (80, "tables"), (100, "setup"),
                   (100, "check"), (150, None)]


def test_readers_of_a_render(monkeypatch):
    ctx = ctx_of(REGEN, monkeypatch=monkeypatch)
    assert spec.reader("read_idle_ms.render")(ctx) == pytest.approx(
        180 * MS)
    assert spec.reader("setup_idle_ms.render")(ctx) == pytest.approx(
        100 * MS)
    # call 5's vertices over its B1 lanes; call 4 is outside the window
    assert spec.reader("live_lane_share.render")(ctx) == pytest.approx(75.0)
    assert spec.reader("train_bwd_device_ms")(ctx) is None


def test_scan_setup_counts_every_chunks_rays(monkeypatch):
    recs = [rec("render", 1100, 9900),
            rec("setup", 1200, 1300, parent=0),
            rec("tables", 1210, 1290, parent=1, read=True),
            rec("rays", 1310, 1800, parent=0),
            rec("bounces", 1800, 3000, parent=0),
            rec("B2", 1900, 1950, parent=4, lanes=100, live=60),
            rec("B2", 2000, 2050, parent=4, lanes=100, live=20),
            rec("rays", 3000, 3400, parent=0)]
    ops = [("k", 1000, 1250), ("k", 1270, 1320), ("k", 1350, 1500),
           ("k", 1600, 3100), ("k", 3200, 10000)]
    ctx = ctx_of(recs, ops, monkeypatch=monkeypatch)
    # 1250 opens in tables (a read), 1320 and 1500 in the first rays,
    # 3100 in the second
    assert spec.reader("setup_idle_ms.scan")(ctx) == pytest.approx(
        (30 + 100 + 100) * MS)
    assert spec.reader("read_idle_ms.render")(ctx) == pytest.approx(20 * MS)
    assert spec.reader("live_lane_share.scan")(ctx) == pytest.approx(40.0)


def test_readers_of_train_steps(monkeypatch):
    recs = []
    for k, t in enumerate((1100, 5100)):
        i = len(recs)
        recs += [rec("train_step", t, t + 3800, call=k),
                 rec("forward", t + 100, t + 1000, parent=i, call=k),
                 rec("tables", t + 200, t + 300, parent=i + 1, call=k,
                     read=True),
                 rec("bounces", t + 300, t + 1000, parent=i + 1, call=k),
                 rec("B2", t + 400, t + 500, parent=i + 3, call=k,
                     lanes=100, live=30 + 20 * k),
                 rec("backward", t + 1000, t + 3000, parent=i, call=k,
                     device_ms=2.0 + k),
                 rec("B5", t + 1100, t + 1200, parent=i + 5, call=k,
                     lanes=100),
                 rec("adam", t + 3000, t + 3500, parent=i, call=k,
                     device_ms=0.1)]
    ops = [("k", 1000, 1320), ("k", 1350, 5320), ("k", 5400, 9000)]
    ctx = ctx_of(recs, ops, spans=[("train_step", 1000, 9000)],
                 monkeypatch=monkeypatch, kind="train")
    assert spec.reader("train_bwd_device_ms")(ctx) == pytest.approx(2.5)
    assert spec.reader("live_lane_share.train")(ctx) == pytest.approx(40.0)
    # two holes open in ``tables``: 30 and 80 ns over two steps
    assert spec.reader("read_idle_ms.train")(ctx) == pytest.approx(
        55 * MS)


def test_nothing_to_read(monkeypatch):
    """No device operation (a run without a card), or no call of the
    program in the window (a checkout without the tracer records none):
    every reader returns nothing."""
    names = ["read_idle_ms.render", "setup_idle_ms.scan",
             "live_lane_share.train", "train_bwd_device_ms"]
    for ctx in (ctx_of(REGEN, ops=[], monkeypatch=monkeypatch),
                ctx_of(REGEN[:2], monkeypatch=monkeypatch),
                ctx_of([], monkeypatch=monkeypatch), {"kind": "render"}):
        for name in names:
            assert spec.reader(name)(ctx) is None, name
