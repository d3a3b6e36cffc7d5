"""The program's tracer (``srt_tpu_torch/trace.py``): spans and counters
recorded while a ``torch.profiler`` runs, nothing otherwise.

On the CPU, at toy sizes: a ``render_regen``, a scan ``render`` and a
train step record nothing without a profiler and take no counter slot;
under one each records its span tree (names, parents, one call id a
call, reads marked); the live-lane counters equal the renders' own
counts, and the backward's B5 counts the forward's; a span brackets a
``record_function`` opened inside it on the profiler's clock. The
``cuda``-marked tests hold B2's and B5's live-lane counts against the
lanes alive on entry on every instantiation the scan engine and the train
step take, a B1 launch's device operation inside its span, and the train
step's ``backward`` device time between its kernels' time and the step's
wall; here, without a card, they skip.
"""
from __future__ import annotations

import collections
import json
import warnings

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from srt_tpu_torch import (RenderConfig, get_scene, make_train_step, render,
                           render_regen)
from srt_tpu_torch import trace as tracer
from srt_tpu_torch.diff.inverse import camera_rays
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.kernels import launch_counts
from srt_tpu_torch.kernels.bounce_vjp import bounce_step_auto
from srt_tpu_torch.render.integrator import trace
from srt_tpu_torch.scene.ir import SceneFlags

torch.set_num_threads(1)

REGEN = RenderConfig(width=16, height=16, spp=2, max_depth=6, wavefront=128,
                     seed=3)
SCAN = RenderConfig(width=16, height=16, spp=2, max_depth=6, pixel_chunk=128,
                    sample_chunk=1, seed=3)
TRAIN = dict(width=8, height=8, spp=1, max_depth=3)


def _scene(name="ball_scenes", device="cpu"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene(name, device=device)
    return scene, cam


def _step(scene, cam, device="cpu"):
    return make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           engine="scan", device=device, **TRAIN)


def _activities():
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])


def _profiled(fn):
    """``fn()`` under the profiler, the tracer's buffer emptied first;
    returns ``(fn's result, the records, the profiler)``."""
    tracer.clear()
    with warnings.catch_warnings(), profile(activities=_activities()) as p:
        warnings.filterwarnings("ignore", message=".*clears events.*")
        out = fn()
    return out, tracer.records(), p


def _tree(recs, call):
    """``(name, parent's name, read)`` of a call's records, counted."""
    return collections.Counter(
        (r["name"], recs[r["parent"]]["name"] if r["parent"] is not None
         else None, r["read"]) for r in recs if r["call"] == call)


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    """Without a profiler the three calls record nothing and take no live
    slot; B2's arguments carry a null counter."""
    def no_slot(*a):
        raise AssertionError("a live slot without a profiler")
    monkeypatch.setattr(tracer, "live_slot", no_slot)
    tracer.clear()
    scene, cam = _scene()
    render_regen(scene, cam, REGEN)
    render(scene, cam, SCAN)
    _step(scene, cam)(torch.full((8, 8, 3), 0.3), 0)
    assert tracer.records() == [] and tracer.dropped() == 0
    assert not tracer.ON
    flags = SceneFlags.of(scene)
    (o, d, t), salt = camera_rays(cam, torch.arange(64), 1, width=8,
                                  height=8, seed=1)
    st = dict(o=o, d=d, time=t, beta=torch.ones_like(o),
              radiance=torch.zeros_like(o), salt=salt,
              alive=torch.ones(64, dtype=torch.bool),
              depth=torch.zeros(64, dtype=torch.int32))
    args, _ = kb.fwd_args(scene, flags, kb.build_tables(scene, flags), st,
                          kb.StepSpec(max_depth=4))
    assert args.live is None


def test_regen_render_records_its_tree():
    scene, cam = _scene()
    (img, m), recs, _ = _profiled(
        lambda: render_regen(scene, cam, REGEN, metrics=True))
    assert {r["call"] for r in recs} == {recs[0]["call"]}
    entry = recs[0]
    assert (entry["name"], entry["parent"]) == ("render_regen", None)
    blocks = m.bounces // 8
    assert _tree(recs, entry["call"]) == collections.Counter({
        ("render_regen", None, False): 1,
        ("setup", "render_regen", False): 1,
        # the route's tables and RegenInputs' tables
        ("tables", "setup", True): 2,
        ("B1", "render_regen", False): m.bounces,
        ("film_sum", "render_regen", False): m.bounces,
        ("check", "render_regen", True): blocks,
        ("finish", "render_regen", False): 1})
    # the film's live lanes, read at readout, are the render's vertices
    assert entry["attrs"]["path_vertices"] == m.path_vertices > 0
    lanes = [r["attrs"]["lanes"] for r in recs if r["name"] == "B1"]
    assert lanes == [REGEN.wavefront] * m.bounces
    for r in recs:
        assert entry["t0"] <= r["t0"] <= r["t1"] <= entry["t1"]


def test_scan_render_records_its_tree_and_live_lanes():
    scene, cam = _scene()
    (img, m), recs, _ = _profiled(
        lambda: render(scene, cam, SCAN, metrics=True))
    call = recs[0]["call"]
    chunks = SCAN.spp * (SCAN.width * SCAN.height // SCAN.pixel_chunk)
    assert _tree(recs, call) == collections.Counter({
        ("render", None, False): 1, ("setup", "render", False): 1,
        ("tables", "setup", True): 1, ("rays", "render", False): chunks,
        ("bounces", "render", False): chunks,
        ("B2", "bounces", False): chunks * SCAN.max_depth,
        ("sum", "render", False): 1})
    live = np.array([r["attrs"]["live"] for r in recs if r["name"] == "B2"])
    lanes = {r["attrs"]["lanes"] for r in recs if r["name"] == "B2"}
    assert lanes == {SCAN.pixel_chunk}
    # each chunk's bounces in turn: summed over the chunks, the histogram
    per_bounce = live.reshape(chunks, SCAN.max_depth).sum(0)
    np.testing.assert_array_equal(per_bounce, m.alive_per_bounce)


def test_train_step_records_its_tree_and_live_lanes():
    scene, cam = _scene()
    step = _step(scene, cam)
    target = torch.full((8, 8, 3), 0.3)
    _, recs, _ = _profiled(lambda: step(target, 7))
    call = recs[0]["call"]
    d = TRAIN["max_depth"]
    assert _tree(recs, call) == collections.Counter({
        ("train_step", None, False): 1, ("forward", "train_step", False): 1,
        ("rays", "forward", False): 1, ("tables", "forward", True): 1,
        ("bounces", "forward", False): 1, ("B2", "bounces", False): d,
        ("backward", "train_step", False): 1,
        ("B5", "backward", False): d, ("adam", "train_step", False): 1})
    # no device, no events
    assert all("device_ms" not in r["attrs"] for r in recs)
    live = [r["attrs"]["live"] for r in recs if r["name"] == "B2"]
    # the forward's bounces, traced again with the histogram
    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=d)
    rays, salt = camera_rays(cam, torch.arange(64), TRAIN["spp"], width=8,
                             height=8, seed=7)
    with torch.no_grad():
        _, aux = trace(lambda st: bounce_step_auto(scene, flags, tables, st,
                                                   spec),
                       rays, salt, max_depth=d, with_aux=True)
    assert live == aux["alive_per_bounce"].tolist()


def test_train_step_b5_spans_count_the_lanes_they_sweep():
    """The backward's B5 spans carry ``live``, the lanes each sweeps: the
    bounce's ``alive.sum()``, so the forward's B2 counts in reverse bounce
    order, summing to the same lanes over the step. The benchmark's
    ``live_lane_share.train`` reads the B2 spans alone: the B5 counts
    leave it as the forward's share."""
    from benchmark import spec
    from benchmark.trace import DeviceTrace

    scene, cam = _scene()
    step = _step(scene, cam)
    _, recs, _ = _profiled(lambda: step(torch.full((8, 8, 3), 0.3), 7))
    b2 = [r["attrs"] for r in recs if r["name"] == "B2"]
    b5 = [r["attrs"] for r in recs if r["name"] == "B5"]
    assert len(b5) == len(b2) == TRAIN["max_depth"]
    assert [a["live"] for a in b5] == [a["live"] for a in b2][::-1]
    assert [a["lanes"] for a in b5] == [a["lanes"] for a in b2]
    assert 0 < sum(a["live"] for a in b5) < sum(a["lanes"] for a in b5)
    t0, t1 = recs[0]["t0"], recs[0]["t1"]
    ctx = {"kind": "train", "trace": DeviceTrace(
        [("k", t0, t1)], [("train_step", t0, t1)], 1.0)}
    share = spec.reader("live_lane_share.train")(ctx)
    assert share == pytest.approx(100.0 * sum(a["live"] for a in b2)
                                  / sum(a["lanes"] for a in b2))


def test_calls_take_one_id_each():
    scene, cam = _scene()
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=3, wavefront=64)
    _, recs, _ = _profiled(lambda: [render_regen(scene, cam, cfg)
                                    for _ in range(3)])
    entries = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in entries] == ["render_regen"] * 3
    assert len({r["call"] for r in entries}) == 3
    for r in recs:
        top = r
        while top["parent"] is not None:
            top = recs[top["parent"]]
        assert top["call"] == r["call"]


def test_spans_share_the_profilers_clock():
    """A span brackets a ``record_function`` opened inside it, on the
    profiler's own timestamps, within 100 us."""
    def body():
        with record_function("warm"):
            pass
        with tracer.entry("outer"), tracer.span("inner"):
            with record_function("marker"):
                torch.ones(1000).sum()
    _, recs, p = _profiled(body)
    inner = [r for r in recs if r["name"] == "inner"][0]
    ev = [e for e in p.profiler.kineto_results.events()
          if e.name() == "marker"][0]
    t0, t1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert inner["t0"] - 100_000 <= t0 <= t1 <= inner["t1"] + 100_000


def test_buffer_is_bounded_and_counts_what_it_drops(monkeypatch, tmp_path):
    monkeypatch.setattr(tracer, "MAX_RECORDS", 5)
    scene, cam = _scene()
    _, recs, _ = _profiled(lambda: render_regen(scene, cam, REGEN))
    assert len(recs) == 5 and tracer.dropped() > 0
    assert [r["name"] for r in recs[:3]] == ["render_regen", "setup",
                                             "tables"]
    n = tracer.write_chrome(str(tmp_path / "spans.json"))
    with open(tmp_path / "spans.json") as f:
        out = json.load(f)
    assert n == len(out["traceEvents"]) == 5
    assert out["dropped"] == tracer.dropped()
    ev = out["traceEvents"][0]
    assert ev["name"] == "render_regen" and ev["ph"] == "X"
    assert ev["ts"] == recs[0]["t0"] / 1e3
    tracer.clear()
    assert tracer.records() == [] and tracer.dropped() == 0


def test_command_line_writes_the_spans(tmp_path):
    """``--profile DIR`` writes the profiler's trace and the program's
    spans beside it, as Chrome trace events."""
    from srt_tpu_torch import cli
    tracer.clear()
    out = tmp_path / "prof"
    assert cli.main(["--scene", "ball_scenes", "--width", "8", "--spp", "1",
                     "--max-depth", "3", "--device", "cpu", "--out",
                     str(tmp_path / "x.png"), "--profile", str(out)]) == 0
    with open(out / "srt_spans.json") as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e["name"] for e in events)
    assert names["render_regen"] == 1 and names["B1"] == names["film_sum"]
    assert any(p.name.endswith(".pt.trace.json") for p in out.iterdir())


def test_launch_counts_keep_their_keys():
    assert list(launch_counts()) == [
        "B1", "B2", "B2 parity", "B3", "B4", "B5", "B5 rich", "B6",
        "film_sum", "segment_sum"]


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _state(scene, cam, device, n=20000, bounces=2):
    """Camera rays of a 64x64 image after ``bounces`` plain bounces, a
    seeded half of the lanes dead."""
    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=50)
    r = np.random.default_rng(5)
    pix = torch.from_numpy(r.integers(0, 64 * 64, n)).to(device)
    (o, d, t), salt = camera_rays(cam, pix, 1, width=64, height=64, seed=3)
    st = dict(o=o, d=d, time=t, beta=torch.ones_like(o),
              radiance=torch.zeros_like(o), salt=salt,
              alive=torch.ones(n, dtype=torch.bool, device=device),
              depth=torch.zeros(n, dtype=torch.int32, device=device))
    with torch.no_grad():
        for _ in range(bounces):
            st = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    half = torch.from_numpy(r.random(n) < 0.5).to(device)
    st = {k: v.contiguous() for k, v in st.items()}
    st["alive"] = st["alive"] & ~half
    return flags, tables, spec, st


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ball_scenes", "two_perlin_spheres",
                                  "random_scene", "cornell_boxes"])
def test_b2_live_lanes_on_gpu(name, cuda_device):
    """B2's count equals the lanes alive on entry, lean (ball_scenes),
    rich (two_perlin_spheres), rich with kMoving (random_scene) and with
    the external hit (cornell_boxes), at G = 1, 2, 4 and 8; and through
    the wrapper, where a recording call hands it a slot."""
    scene, cam = _scene(name, cuda_device)
    flags, tables, spec, st = _state(scene, cam, cuda_device)
    tri = (ki.intersect_tris(scene, ki.pack_tables(scene), st["o"], st["d"])
           if scene.n_tris else None)
    want = int(st["alive"].sum())
    assert 0 < want < st["alive"].shape[0]
    for g in kb.SHARES:
        args, out = kb.fwd_args(scene, flags, tables, st, spec, tri)
        live = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        args.shares, args.live = g, live.data_ptr()
        kb.launch("srt_bounce", args, cuda_device)
        assert int(live) == want, g
    _, recs, _ = _profiled(lambda: _entry_fwd(scene, flags, tables, st,
                                              spec, tri))
    (b2,) = [r for r in recs if r["name"] == "B2"]
    assert b2["attrs"] == {"lanes": st["alive"].shape[0], "live": want}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ball_scenes", "two_perlin_spheres"])
def test_b5_live_lanes_on_gpu(name, cuda_device):
    """B5's span carries the lanes it swept, the lanes alive on entry,
    lean (ball_scenes) and rich (two_perlin_spheres), counted by the
    kernel into the slot a recording call hands it."""
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    scene, cam = _scene(name, cuda_device)
    flags, tables, spec, st = _state(scene, cam, cuda_device)
    r = np.random.default_rng(8)
    ct = {k: torch.from_numpy(r.standard_normal(st["o"].shape)
                              .astype(np.float32)).to(cuda_device)
          for k in kbb.ROWS}
    want = int(st["alive"].sum())
    assert 0 < want < st["alive"].shape[0]

    def body():
        with tracer.entry("test"):
            return kbb.bounce_bwd(scene, flags, tables, st, ct, spec)
    _, recs, _ = _profiled(body)
    (b5,) = [r for r in recs if r["name"] == "B5"]
    assert b5["attrs"] == {"lanes": st["alive"].shape[0], "live": want}


def _entry_fwd(scene, flags, tables, st, spec, tri):
    with tracer.entry("test"):
        return kb.bounce_fwd(scene, flags, tables, st, spec, tri)


@pytest.mark.cuda
def test_b1_launch_inside_its_span_on_gpu(cuda_device):
    """A span around one B1 launch and a synchronise holds the kernel's
    device operation, on the profiler's clock."""
    scene, cam = _scene("ball_scenes", cuda_device)
    spec = kb.RegenSpec(width=64, height=64, spp=4, max_depth=8,
                        rr_start=2, pdf_floor=1e-9, seed=1)
    inp = kb.RegenInputs(scene, SceneFlags.of(scene), cam,
                         torch.rand((4, 2)))
    st = kb.new_wavefront(16384, cuda_device)
    kb.regen_bounce(inp, st, spec)          # built and warm

    def body():
        with tracer.entry("test"), tracer.span("launch"):
            kb.regen_bounce(inp, st, spec)
            torch.cuda.synchronize()
    _, recs, p = _profiled(body)
    (span,) = [r for r in recs if r["name"] == "launch"]
    ops = [e for e in p.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and "regen_bounce_kernel" in e.name()]
    assert len(ops) == 1
    t0 = ops[0].start_ns()
    assert span["t0"] <= t0 <= t0 + ops[0].duration_ns() <= span["t1"]


@pytest.mark.cuda
def test_backward_device_time_on_gpu(cuda_device):
    """The step's ``backward`` device time, from its events, is at least
    the device time of its B5 and material-sum launches and at most the
    step's wall (the card waited for before and after)."""
    scene, cam = _scene("ball_scenes", cuda_device)
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           width=128, height=128, spp=4, max_depth=8,
                           engine="scan", device=cuda_device)
    target = torch.full((128, 128, 3), 0.3, device=cuda_device)
    step(target, 0)
    walls = []

    def body():
        torch.cuda.synchronize()
        t0 = tracer.now()
        step(target, 1)
        torch.cuda.synchronize()
        walls.append((tracer.now() - t0) / 1e6)
    _, recs, p = _profiled(body)
    (bwd,) = [r for r in recs if r["name"] == "backward"]
    kernels = sum(e.duration_ns() for e in p.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and ("bounce_bwd_kernel" in e.name()
                       or "segment_sum" in e.name())) / 1e6
    assert kernels > 0
    assert kernels <= bwd["attrs"]["device_ms"] <= walls[0]
    for name in ("forward", "adam"):
        (r,) = [r for r in recs if r["name"] == name]
        assert 0 < r["attrs"]["device_ms"] <= walls[0]
