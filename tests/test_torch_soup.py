"""Scenes given as a triangle soup: ``convert.scene_from_arrays`` derives
the BVH and its clusters (``scene.build.triangle_tables``) where the
arrays hold triangles and no ``bvh_lo``, as ``SceneBuilder.build`` does,
and copies any other dict field by field.

On the CPU: the soup a library scene was built from (caught on its way
into ``triangle_tables``) gives the library's scene bit for bit through
``scene_from_arrays``, on ``teapot_scene(divs=4)`` and ``cornell_boxes``;
a scene without triangles, and one that already has its tables, convert
as a plain copy; the derived teapot renders the library's image to the
bit through both engines and both walks. The ``cuda``-marked test holds
kernel B4's counters of records visited and triangles tested to the
plain walk's counts on the same rays, and B4's outputs with the counters
on to those with them off; here, without a card, it skips.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from srt_tpu_torch import (RenderConfig, convert, get_scene, render,
                           render_regen)
from srt_tpu_torch import trace as tracer
from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.render import intersect as ri
from srt_tpu_torch.scene import build as sb
from srt_tpu_torch.scene.ir import TorchScene

torch.set_num_threads(1)

#: the fields the soup's derivation makes
DERIVED = ("bvh_", "top_", "cl_")
CFG = dict(width=8, height=8, spp=4, max_depth=8, seed=5)


def _library(name: str, monkeypatch, **kw):
    """A library scene, its camera and the soup ``SceneBuilder`` handed to
    ``triangle_tables``, in the order the triangles were added."""
    soups = []
    real = sb.triangle_tables

    def spy(p, uv, n, tm, **k):
        soups.append(dict(tri_p0=p[:, 0].copy(), tri_p1=p[:, 1].copy(),
                          tri_p2=p[:, 2].copy(), tri_uv=uv.copy(),
                          tri_n=n.copy(), tri_mat=tm.copy()))
        return real(p, uv, n, tm, **k)
    monkeypatch.setattr(sb, "triangle_tables", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene(name, device="cpu", **kw)
    monkeypatch.setattr(sb, "triangle_tables", real)
    (soup,) = soups
    return scene, cam, soup


def _arrays(scene: TorchScene) -> dict:
    return {f.name: getattr(scene, f.name).numpy()
            for f in dataclasses.fields(TorchScene)
            if getattr(scene, f.name) is not None}


def _soup_arrays(scene: TorchScene, soup: dict) -> dict:
    """The scene's arrays with its triangles as the soup and no BVH or
    clusters: what a scene generator that builds no tables gives."""
    arrays = {k: v for k, v in _arrays(scene).items()
              if not k.startswith(DERIVED)}
    arrays.update(soup)
    return arrays


def _copied(arrays: dict) -> TorchScene:
    """The field-by-field copy ``scene_from_arrays`` made before it took
    a soup."""
    return TorchScene(**{
        f.name: (None if arrays.get(f.name) is None else
                 torch.from_numpy(np.array(arrays[f.name], order="C")))
        for f in dataclasses.fields(TorchScene)})


def _assert_same(a: TorchScene, b: TorchScene) -> None:
    for f in dataclasses.fields(TorchScene):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert torch.equal(x, y), f.name


@pytest.mark.parametrize("name,kw", [("teapot_scene", {"divs": 4}),
                                     ("cornell_boxes", {})])
def test_soup_derives_the_librarys_tables(name, kw, monkeypatch):
    """Every field, the soup reordered, the BVH and the clusters among
    them, equals the library scene's to the bit."""
    scene, _, soup = _library(name, monkeypatch, **kw)
    assert len(soup["tri_p0"]) == scene.n_tris > 0
    assert scene.top_lo is not None and scene.cl_tris is not None
    arrays = _soup_arrays(scene, soup)
    assert not any(k.startswith(DERIVED) for k in arrays)
    # the soup is not in BVH order: the derivation reorders it
    assert not np.array_equal(soup["tri_p0"], scene.tri_p0.numpy())
    _assert_same(convert.scene_from_arrays(arrays, device="cpu"), scene)


@pytest.mark.parametrize("name,drop", [
    ("ball_scenes", ()), ("ball_scenes", ("bvh_",)),
    ("teapot_scene", ()), ("cornell_boxes", ())])
def test_other_arrays_are_copied(name, drop):
    """A scene without triangles (with its empty BVH rows, or without
    them), and one whose arrays already hold the BVH and clusters, give
    the field-by-field copy."""
    kw = {"divs": 4} if name == "teapot_scene" else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, _, _ = get_scene(name, device="cpu", **kw)
    arrays = {k: v for k, v in _arrays(scene).items()
              if not (drop and k.startswith(drop))}
    got = convert.scene_from_arrays(arrays, device="cpu")
    _assert_same(got, _copied(arrays))
    if not drop:
        _assert_same(got, scene)


@pytest.mark.parametrize("budget", [ri.SINGLE_LEVEL_BUDGET, 0],
                         ids=["B3", "B4"])
def test_derived_teapot_renders_the_librarys_image(budget, monkeypatch):
    """The derived teapot renders the library's image to the bit, at
    8x8x4 spp, through the scan engine and the regeneration engine, with
    the single-level walk and (no budget) the two-level walk."""
    scene, cam, soup = _library("teapot_scene", monkeypatch, divs=4)
    derived = convert.scene_from_arrays(_soup_arrays(scene, soup),
                                        device="cpu")
    monkeypatch.setattr(ri, "SINGLE_LEVEL_BUDGET", budget)
    walk = "B4" if budget == 0 else "B3"
    for fn, extra in ((render, dict(pixel_chunk=64, sample_chunk=2)),
                      (render_regen, dict(wavefront=128))):
        cfg = RenderConfig(**CFG, **extra)
        want, m = fn(scene, cam, cfg, metrics=True)
        got, m2 = fn(derived, cam, cfg, metrics=True)
        assert m.walk == m2.walk == walk
        assert torch.isfinite(want).all() and float(want.mean()) > 0
        assert torch.equal(got, want), fn.__name__


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("divs", [8, 30])
def test_b4_counts_the_plain_walks_visits_and_tests(divs, cuda_device):
    """B4's ``nodes`` equal the plain walk's top-tree and cluster-node
    visits less the padding node the plain walk reads at the end of each
    cluster shorter than its cap (the records the kernel reads), and its
    ``tests`` the plain walk's triangle tests, on the same rays; with the
    counters on, the outputs are those with them off, to the bit; through
    the wrapper under the profiler the ``B4`` span carries both counts."""
    from test_torch_walk_records import walk_records
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, _, _ = get_scene("teapot_scene", device=cuda_device,
                                divs=divs)
    r = np.random.default_rng(divs)
    lo, hi = scene.top_lo[0].cpu().numpy(), scene.top_hi[0].cpu().numpy()
    n = 20000
    target = lo + (hi - lo) * r.uniform(size=(n, 3))
    o = (target + r.standard_normal((n, 3)) * 300).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tables = ki.pack_big_tables(scene)
    oc, dc = (torch.from_numpy(x).to(cuda_device) for x in (o, d))
    _, _, _, _, top_v, cl_v, tests, _ = ri.intersect_tris_big(
        scene, oc, dc, stats=True)
    node_cap = ri.cluster_records(scene)["node_cap"]
    short = walk_records({k: (v.cpu() if torch.is_tensor(v) else v)
                          for k, v in tables.items()}, o, d, node_cap)[6]
    want_nodes = int(top_v.sum() + cl_v.sum()) - int(short.sum())
    want_tests = int(tests.sum())
    assert want_tests > 0 and short.sum() > 0

    args, off = ki.big_kernel_args(tables, oc, dc)
    assert args.count_nodes is None and args.count_tests is None
    ki.launch("srt_intersect_big", args, cuda_device)
    counts = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    args, on = ki.big_kernel_args(tables, oc, dc)
    args.count_nodes = counts.data_ptr()
    args.count_tests = counts.data_ptr() + 8
    ki.launch("srt_intersect_big", args, cuda_device)
    torch.cuda.synchronize()
    assert counts.tolist() == [want_nodes, want_tests]
    for a, b in zip(off, on):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))

    tracer.clear()
    with warnings.catch_warnings(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        warnings.filterwarnings("ignore", message=".*clears events.*")
        with tracer.entry("test"):
            traced = ki.intersect_tris_big(scene, tables, oc, dc)
    (b4,) = [x for x in tracer.records() if x["name"] == "B4"]
    assert b4["attrs"] == {"lanes": n, "nodes": want_nodes,
                           "tests": want_tests}
    for a, b in zip(off, traced):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
