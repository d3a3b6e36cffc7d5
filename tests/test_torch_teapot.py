"""``teapot_scene`` in srt_tpu_torch against the JAX package: the Bézier
tessellation, the native BVH builder, the two-level clusters, the scene
tables, the plain version of kernel B4 (the two-level walk), the plain
version of kernel B2 with metal, dielectric, isotropic and a medium, the
image, and the gates.

Inputs come from numpy with fixed seeds, at small sizes (the teapots at
``divs=6``: 4,512 triangles, two clusters at the builder's caps).
Tolerances:

* tessellation, BVH, clusters and scene tables: bit for bit;
* the walk: the hit mask and the triangle index equal. ``t`` within 2e-5
  absolute or 1e-4 relative; ``u, v`` within 1e-4 on all but 5% of the
  hits, with a median |Δ| under 1e-5. JAX's own bounds between its XLA
  walk and its kernels (``tests/test_pallas.py:35-50``) are 2e-5 and 1e-4
  absolute on rays a few units long; the teapot's rays travel about 1,000
  units to triangles a few units wide, where XLA's contraction of
  Möller–Trumbore's cancelling products into FMAs moves ``t`` by up to
  3.5e-5 relative and ``u, v`` beyond 1e-4 on 3.2% of the aimed rays'
  hits (JAX's XLA walk and its kernel differ from each other by as much:
  ``t`` 948.28784 against 948.29016 on one of those rays). Against the
  port's single-level walk: equal to the bit;
* the bounce: the per-bounce contract of ``srt_tpu_torch.utils.contract``,
  RNG words exact;
* the image: against JAX's ``render_regen`` run as XLA compiles it (jitted,
  so its CPU backend contracts multiply-adds into FMAs where PyTorch does
  not; near-mirror lobes can turn that into resampled paths, ROADMAP C5),
  under the contract's image bounds unloosened: 0.2% of pixels differ
  beyond 1e-2 at 32x32, 4 spp, depth 6, against the 15% bound.
"""
from __future__ import annotations

import dataclasses
import functools
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu.accel import cluster as jax_cluster
from srt_tpu.accel.bvh import build_bvh as jax_build_bvh
from srt_tpu.core import approx as jax_approx
from srt_tpu.core.ray import Ray
from srt_tpu.core.rng import RaySampler
from srt_tpu.pallas import intersect as jax_pallas_intersect
from srt_tpu.pallas.bounce import fused_bounce
from srt_tpu.pallas.intersect_big import intersect_tris_pallas_big
from srt_tpu.render.regen import render_regen as jax_render_regen
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu.scene.library import teapot_scene as jax_teapot_scene
from srt_tpu.scene.teapot import create_teapot as jax_create_teapot
from srt_tpu_torch import (RenderConfig, convert, get_scene, make_train_step,
                           render_regen)
from srt_tpu_torch.accel import cluster
from srt_tpu_torch.accel.bvh import FlatBVH, build_bvh, build_bvh_numpy
from srt_tpu_torch.core import approx, rng
from srt_tpu_torch.kernels import launch_counts
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.render import intersect as ri
from srt_tpu_torch.render.integrator import apply_media
from srt_tpu_torch.scene.ir import (PORT_FLAGS, MaterialType, SceneFlags,
                                    TorchScene, require_covered)
from srt_tpu_torch.scene.teapot import create_teapot
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)

_DIVS = 6


@pytest.fixture
def flush_denormals():
    # XLA's CPU backend flushes float32 denormals; do the same here (C6)
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _arrays(scene) -> dict:
    return {k: (None if v is None else np.asarray(v))
            for k, v in scene._asdict().items()}


@functools.lru_cache(maxsize=None)
def _teapot():
    """(JAX scene, JAX camera, JAX info, port scene, port camera, port
    info) at ``divs=6``, each built by its own package's library."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene_j, cam_j, info_j = jax_teapot_scene(aspect=1.0, divs=_DIVS)
        scene, cam, info = get_scene("teapot_scene", device="cpu",
                                     divs=_DIVS)
    return scene_j, cam_j, info_j, scene, cam, info


@pytest.mark.parametrize("divs,smooth", [(3, False), (3, True), (6, False),
                                         (6, True)])
def test_create_teapot_matches_jax(divs, smooth):
    got = create_teapot(scale=40.0, divs=divs, smooth=smooth)
    want = jax_create_teapot(scale=40.0, divs=divs, smooth=smooth)
    assert got.n_tris == want.n_tris > 0
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _soup(t: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((t, 3, 3)) \
        .astype(np.float32)


def _degenerate() -> np.ndarray:
    # identical triangles: every split takes the median fallback
    return np.tile(np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]],
                            np.float32), (33, 1, 1))


@pytest.mark.parametrize("verts", [
    pytest.param(lambda: _soup(37), id="soup37"),
    pytest.param(lambda: _soup(300, 1), id="soup300"),
    pytest.param(lambda: _soup(1500, 2), id="soup1500"),
    pytest.param(_degenerate, id="degenerate")])
def test_native_bvh_matches_numpy_and_jax(verts):
    """The native builder against its plain version (the numpy builder)
    and against the JAX package's ``build_bvh``, bit for bit."""
    v = verts()
    got = build_bvh(v)
    for want in (build_bvh_numpy(v), jax_build_bvh(v)):
        np.testing.assert_array_equal(got[1], want[1])
        for k in got[0]._fields:
            a, b = getattr(got[0], k), getattr(want[0], k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert sorted(got[1].tolist()) == list(range(len(v)))


@pytest.mark.parametrize("case,caps,n_clusters", [
    ("soup1500", (128, 256), None), ("teapot", (2048, 4096), 2)])
def test_clusters_match_jax(case, caps, n_clusters):
    """``build_clusters`` on a soup's BVH at small caps and on the
    teapot's own BVH at the builder's caps, bit for bit."""
    if case == "teapot":
        s = _teapot()[3]
        bvh = FlatBVH(*(getattr(s, f"bvh_{k}").numpy()
                        for k in FlatBVH._fields))
        p = torch.stack([s.tri_p0, s.tri_p1, s.tri_p2], 1).numpy()
    else:
        v = _soup(1500, 2)
        bvh, order = build_bvh(v)
        p = v[order]
    kw = dict(node_cap=caps[0], tri_cap=caps[1])
    got = cluster.build_clusters(bvh, p[:, 0], p[:, 1], p[:, 2], **kw)
    want = jax_cluster.build_clusters(bvh, p[:, 0], p[:, 1], p[:, 2], **kw)
    for k in got._fields:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.n_clusters == (n_clusters or got.n_clusters) > 1


def test_teapot_tables_bit_equal():
    scene_j, cam_j, info_j, scene, cam, info = _teapot()
    want = convert.scene_from_arrays(_arrays(scene_j), device="cpu")
    for f in dataclasses.fields(TorchScene):
        a, b = getattr(scene, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a, b), f.name
    assert scene.n_tris == 4512 and scene.cl_tris.shape[0] == 2
    assert scene.n_media == 1 and scene.n_spheres == 2
    info = dict(info)
    host_s = info.pop("host_s")
    assert info == info_j
    assert sorted(host_s) == ["bvh", "clusters", "tessellation", "upload"]
    assert all(s >= 0.0 for s in host_s.values())
    flags = SceneFlags.of(scene)
    want_flags = JaxSceneFlags.of(scene_j)._asdict()
    shared = [k for k in flags._fields if k not in PORT_FLAGS]
    assert ({k: getattr(flags, k) for k in shared}
            == {k: want_flags[k] for k in shared})
    assert not flags.mesh_media
    assert flags.fused_bounce
    rec_j = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()},
        device="cpu").record()
    np.testing.assert_allclose(cam.record().numpy(), rec_j.numpy(),
                               rtol=1e-6, atol=1e-6)
    # the kernel's records hold the clusters' planes row for row, without
    # the padding to the caps
    tb = ki.pack_big_tables(scene)
    assert tb["top"].shape == (scene.top_skip.shape[0], 8)
    nn = tb["clusters"][:, 3].tolist()
    assert len(nn) == 2 and max(nn) < 2048
    assert tb["nodes"].shape == (sum(nn), 8) and tb["tris"].shape == (
        scene.n_tris, 12)
    skips = tb["nodes"][:, 3].contiguous().view(torch.int32)
    assert torch.equal(skips[:nn[0]],
                       scene.cl_nodes_i[0, 0].reshape(-1)[:nn[0]])
    k1 = int(tb["clusters"][1, 1])
    assert torch.equal(tb["tris"][k1:, 0],
                       scene.cl_tris[1, 0].reshape(-1)[:scene.n_tris - k1])


def _camera_rays(n: int):
    scene_j, cam_j = _teapot()[:2]
    r = np.random.default_rng(7)
    s, t = (r.uniform(size=n).astype(np.float32) for _ in range(2))
    sampler = RaySampler.create(0, r.integers(0, 1 << 18, n).astype(np.int32),
                                np.zeros(n, np.int32))
    ray = cam_j.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                     sampler.uniform(34))
    return np.asarray(ray.origin), np.asarray(ray.direction)


def _aimed_rays(n: int, seed: int = 3):
    """Rays from around the camera at random points of the teapots' own
    triangles and of the glass sphere, so most of them hit."""
    scene = _teapot()[3]
    r = np.random.default_rng(seed)
    p = torch.stack([scene.tri_p0, scene.tri_p1, scene.tri_p2], 1).numpy()
    k = r.integers(0, len(p), n)
    w = r.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
    target = (p[k] * w[:, :, None]).sum(1)
    glass = r.random(n) < 0.3
    target[glass] = (np.asarray([280.0, 30.0, 70.0], np.float32)
                     + r.uniform(-20, 20, (int(glass.sum()), 3)))
    o = (np.asarray([100.0, 800.0, -400.0], np.float32)
         + r.uniform(-50, 50, (n, 3))).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _soup_case():
    """A 1,500-triangle soup clustered at caps 128/256 (many clusters, a
    deep top tree) and random rays through it."""
    from srt_tpu.io.mesh import TriMesh
    from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
    r = np.random.default_rng(0)
    b = JaxSceneBuilder(cluster_node_cap=128, cluster_tri_cap=256)
    mat = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    b.trimesh(TriMesh(positions=_soup(1500, 2), uvs=None, normals=None), mat)
    o = r.standard_normal((2000, 3)).astype(np.float32) * 3
    d = r.standard_normal((2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return b.build(), o, d


@pytest.mark.parametrize("case", ["camera", "aimed", "soup1500"])
def test_two_level_walk_matches_jax(case):
    """The plain B4 against ``intersect_tris_pallas_big(interpret=True)``
    and against the port's single-level walk (plain B3)."""
    if case == "soup1500":
        scene_j, o, d = _soup_case()
        scene = convert.scene_from_arrays(_arrays(scene_j), device="cpu")
    else:
        scene_j, scene = _teapot()[0], _teapot()[3]
        o, d = _camera_rays(2048) if case == "camera" else _aimed_rays(2048)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t, u, v, idx, top_v, cl_v, tests, seen = ri.intersect_tris_big(
        scene, to, td, stats=True)
    ray = Ray(origin=o, direction=d, time=np.zeros(len(o), np.float32))
    tp, up, vp, ip = (np.asarray(a) for a in intersect_tris_pallas_big(
        scene_j, ray, 1e-3, interpret=True))
    hit = (t < 3e38).numpy()
    np.testing.assert_array_equal(hit, tp < 3e38)
    assert hit.mean() > {"camera": 0.05, "aimed": 0.5, "soup1500": 0.2}[case]
    np.testing.assert_array_equal(idx.numpy()[hit], ip[hit])
    np.testing.assert_allclose(t.numpy()[hit], tp[hit], rtol=1e-4, atol=2e-5)
    duv = np.maximum(np.abs(u.numpy() - up), np.abs(v.numpy() - vp))[hit]
    assert (duv > 1e-4).mean() <= 0.05 and np.median(duv) <= 1e-5
    single = ri.intersect_tris(scene, to, td)
    for a, b in zip((t, u, v, idx), single):
        assert torch.equal(a, b)
    # what the bound counts: every ray visits the root, a hit entered a
    # cluster and tested a triangle; the records read hold the root and
    # every hit triangle, and no more records than the visits and tests
    assert (top_v >= 1).all() and (cl_v.numpy()[hit] >= 1).all()
    assert (tests.numpy()[hit] >= 1).all()
    tables, rec = ki.pack_big_tables(scene), ri.cluster_records(scene)
    top_seen, node_seen, tri_seen = seen
    assert top_seen.shape == (tables["top"].shape[0],) and bool(top_seen[0])
    assert node_seen.shape == (rec["skip"].shape[0],)
    assert tri_seen.shape == (rec["p"].shape[0],)
    assert int(node_seen.sum()) <= int(cl_v.sum())
    assert int(tri_seen.sum()) <= int(tests.sum())
    # a hit's triangle is read: its record holds the hit's vertices
    read = {tuple(r) for r in rec["p"][tri_seen].tolist()}
    hit_tris = torch.cat([scene.tri_p0, scene.tri_p1, scene.tri_p2], 1)[
        idx[torch.from_numpy(hit)]]
    assert all(tuple(r) in read for r in hit_tris.tolist())
    # the wrapper takes the plain version on CPU tensors, launching nothing
    launches = launch_counts()["B4"]
    got = ki.intersect_tris_big(scene, tables, to, td)
    assert launch_counts()["B4"] == launches
    for a, b in zip(got, (t, u, v, idx)):
        assert torch.equal(a, b)


def test_cbrt_pos_matches_jax():
    x = np.random.default_rng(4).random(4096).astype(np.float32)
    x[:3] = (0.0, 1e-12, 1.0)
    np.testing.assert_allclose(approx.cbrt_pos(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_approx.cbrt_pos(x)), rtol=2e-7,
                               atol=0)


def _teapot_state(n: int = 2048) -> dict:
    """A mid-flight wavefront on the teapots and the glass sphere: aimed
    rays take one plain bounce (a lane that ends takes a fresh aimed ray),
    then a seeded quarter of the lanes is marked dead."""
    scene = _teapot()[3]
    flags = SceneFlags.of(scene)
    o, d = _aimed_rays(2 * n, seed=5)
    r = np.random.default_rng(13)
    sampler = RaySampler.create(0, r.integers(0, 1 << 18, 2 * n)
                                .astype(np.int32),
                                r.integers(0, 16, 2 * n).astype(np.int32))
    salt = torch.from_numpy(np.asarray(sampler.salt).astype(np.int64)) \
        .to(torch.int32)
    st = dict(o=torch.from_numpy(o[:n]), d=torch.from_numpy(d[:n]),
              time=torch.zeros(n), beta=torch.ones((n, 3)),
              radiance=torch.zeros((n, 3)),
              alive=torch.ones(n, dtype=torch.bool),
              depth=torch.zeros(n, dtype=torch.int32), salt=salt[:n])
    spec = kb.StepSpec(max_depth=8)
    st = kb.bounce_step_ref(scene, flags, kb.build_tables(scene, flags)["mat"],
                            st, spec)
    lanes = torch.nonzero(~st["alive"])[:, 0]
    src = torch.arange(n, n + len(lanes))
    st["o"][lanes] = torch.from_numpy(o)[src]
    st["d"][lanes] = torch.from_numpy(d)[src]
    st["salt"][lanes] = salt[src]
    st["beta"][lanes] = 1.0
    st["radiance"][lanes] = 0.0
    st["depth"][lanes] = 0
    st["alive"][lanes] = True
    st["alive"] &= torch.from_numpy(r.random(n) >= 0.25)
    return {k: v.contiguous() for k, v in st.items()}


@pytest.mark.parametrize("medium", ["sphere", "box"])
def test_specular_media_bounce_matches_fused_bounce(medium, flush_denormals,
                                                    monkeypatch):
    """One bounce of the plain B2 on a teapot wavefront (its triangle hit
    from the plain walk) against JAX's ``fused_bounce(interpret=True)``
    with its external-hit planes (from JAX's XLA walk), lane by lane: the
    metal fuzz ball, the dielectric's Schlick choice, the isotropic phase
    function and the medium's free flight all draw on the lanes' RNG
    words, which are the JAX package's bit for bit. The scene's medium is
    the glass sphere's; the ``box`` case swaps it for the box around the
    sphere (kind 1, half extents 30) in both packages' tables."""
    monkeypatch.setenv("SRT_TPU_PALLAS", "off")
    scene_j, _, _, scene, _, _ = _teapot()
    if medium == "box":
        kind, half = np.ones(1, np.int32), np.full((1, 3), 30.0, np.float32)
        scene = dataclasses.replace(scene, med_kind=torch.from_numpy(kind),
                                    med_half=torch.from_numpy(half))
        scene_j = scene_j._replace(med_kind=jax.numpy.asarray(kind),
                                   med_half=jax.numpy.asarray(half))
    flags = SceneFlags.of(scene)
    st = _teapot_state()
    spec = kb.StepSpec(max_depth=8)
    tables = kb.build_tables(scene, flags)
    assert tables["med"].shape == (1, 10)
    # which families this bounce shades: every specular one and the medium
    salt = rng.hash_combine(rng.as_word(st["salt"]), rng.as_word(st["depth"]))
    hit = apply_media(scene, st["o"], st["d"], salt, ri.intersect_scene(
        scene, st["o"], st["d"]))
    mt = scene.mat_type[hit.mat][st["alive"] & hit.hit]
    for m in (MaterialType.METAL, MaterialType.DIELECTRIC,
              MaterialType.ISOTROPIC, MaterialType.BECKMANN):
        assert int((mt == int(m)).sum()) >= 20, m
    # the RNG words the bounce draws equal JAX's
    sampler = RaySampler(salt=st["salt"].numpy().view(np.uint32)).fold(
        st["depth"].numpy())
    for dim in (0, 8, 9, 10, 11, 12, 14):
        np.testing.assert_array_equal(rng.uniform(salt, dim).numpy(),
                                      np.asarray(sampler.uniform(dim)))
    launches = launch_counts()["B2"]
    got = kb.bounce_fwd(scene, flags, tables, st, spec,
                        ri.intersect_tris_any(scene, st["o"], st["d"]))
    assert launch_counts()["B2"] == launches
    state_j = {k: v.numpy() for k, v in st.items()}
    state_j["salt"] = state_j["salt"].view(np.uint32)
    step = jax.jit(functools.partial(
        fused_bounce, max_depth=8, rr_start=1 << 30,
        flags=JaxSceneFlags.of(scene_j), interpret=True))
    want = {k: np.asarray(v) for k, v in step(scene_j, state_j).items()}
    np.testing.assert_array_equal(got["depth"].numpy(), want["depth"])
    np.testing.assert_array_equal(got["salt"].numpy().view(np.uint32),
                                  want["salt"])
    contract.check_bounce(want, {k: v.numpy() for k, v in got.items()})


def test_image_matches_jax(flush_denormals, monkeypatch):
    """The 32x32, 4 spp, depth 6 teapot image through the plain two-level
    walk (the budget patched to 0) against JAX's ``render_regen``."""
    monkeypatch.delenv("SRT_TPU_PALLAS", raising=False)
    monkeypatch.setattr(ri, "SINGLE_LEVEL_BUDGET", 0)
    calls = {"big": 0, "single": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ki, "intersect_tris_big",
                        counted("big", ki.intersect_tris_big))
    monkeypatch.setattr(ki, "intersect_tris",
                        counted("single", ki.intersect_tris))
    scene_j, cam_j, _, scene, cam, _ = _teapot()
    cfg = dict(width=32, height=32, spp=4, max_depth=6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        img_j, m_j = jax_render_regen(scene_j, cam_j,
                                      JaxRenderConfig(**cfg), metrics=True)
    img, m = render_regen(scene, cam, RenderConfig(**cfg), metrics=True)
    assert calls == {"big": m.bounces, "single": 0}
    assert img.shape == (32, 32, 3) and img.dtype == torch.float32
    contract.check_image(img.numpy(), np.asarray(img_j))
    assert m.nan_scrubbed == m_j.nan_scrubbed == 0
    assert abs(m.path_vertices - m_j.path_vertices) < 0.015 * m_j.path_vertices
    assert 0.5 < float(img.mean()) < 0.65


def test_dispatch_rule_matches_jax():
    """The same scenes take the same walk in both packages: the teapot at
    full size (1,278,400 triangles, 774,153 nodes) the two-level walk,
    ``cornell_boxes`` the single-level one."""
    full = types.SimpleNamespace(n_tris=1_278_400, n_bvh_nodes=774_153)
    cornell = get_scene("cornell_boxes", device="cpu")[0]
    assert ri.two_level(full) and not ri.two_level(cornell)
    for s in (full, cornell, _teapot()[3]):
        assert ri.two_level(s) == (not jax_pallas_intersect.pallas_available(
            s, interpret=True))
    assert not ri.two_level(_teapot()[3])       # divs=6: 4,512 triangles


def test_render_takes_one_walk_a_bounce(monkeypatch):
    """Above the budget every bounce runs one B4 and one B2, below it one
    B3 and one B2; B1 never runs on a triangle scene."""
    calls = {"b1": 0, "b2": 0, "b3": 0, "b4": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kb, "regen_bounce", counted("b1", kb.regen_bounce))
    monkeypatch.setattr(kb, "bounce_fwd", counted("b2", kb.bounce_fwd))
    monkeypatch.setattr(ki, "intersect_tris", counted("b3", ki.intersect_tris))
    monkeypatch.setattr(ki, "intersect_tris_big",
                        counted("b4", ki.intersect_tris_big))
    scene, cam = _teapot()[3:5]
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=4)
    _, m = render_regen(scene, cam, cfg, metrics=True)
    assert calls == {"b1": 0, "b2": m.bounces, "b3": m.bounces, "b4": 0}
    calls.update(b2=0, b3=0)
    monkeypatch.setattr(ri, "SINGLE_LEVEL_BUDGET", 0)
    img, m = render_regen(scene, cam, cfg, metrics=True)
    assert calls == {"b1": 0, "b2": m.bounces, "b3": 0, "b4": m.bounces}
    assert torch.equal(img, render_regen(scene, cam, cfg, plain=True))


def _balls_with(**fields) -> TorchScene:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene = get_scene("ball_scenes", device="cpu")[0]
    return dataclasses.replace(scene, **fields)


def _one_medium(kind: int) -> dict:
    return dict(med_kind=torch.tensor([kind], dtype=torch.int32),
                med_center=torch.zeros((1, 3)), med_radius=torch.ones(1),
                med_half=torch.ones((1, 3)), med_density=torch.ones(1),
                med_mat=torch.zeros(1, dtype=torch.int32))


def _metal_balls() -> TorchScene:
    scene = _balls_with()
    mt = scene.mat_type.clone()
    mt[-1] = int(MaterialType.METAL)
    return dataclasses.replace(scene, mat_type=mt)


@pytest.mark.parametrize("make", [
    pytest.param(lambda: _balls_with(**_one_medium(0)), id="medium"),
    pytest.param(_metal_balls, id="metal")])
def test_triangle_free_scenes_still_raise(make):
    """Without triangles the bounce is kernel B1, whose rich instantiation
    holds the specular branch and the media sweep: the render gate admits
    them, and so does the train step, whose backward is B5's rich
    instantiation. A medium bounded by a mesh (A7) trains through
    autograd of the plain bounce; B5 refuses it."""
    scene = make()
    flags = SceneFlags.of(scene)
    require_covered(scene, flags)
    cam = get_scene("ball_scenes", device="cpu")[1]
    kbb.require_bwd_kernel(scene, flags)
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           width=4, height=4, spp=1, max_depth=2,
                           device="cpu")
    assert np.isfinite(float(step(torch.full((4, 4, 3), 0.3), 0)))
    mesh = dataclasses.replace(scene, **_one_medium(2))
    step = make_train_step(mesh, cam, {"tex_color": mesh.tex_color}, width=4,
                           height=4, spp=1, max_depth=2, device="cpu")
    assert np.isfinite(float(step(torch.full((4, 4, 3), 0.3), 0)))
    with pytest.raises(NotImplementedError, match="mesh-bounded media"):
        kbb.require_bwd_kernel(mesh, SceneFlags.of(mesh))


def test_gates_on_the_teapot():
    """The teapot is covered, and so is a mesh-bounded medium in it, which
    the bounce kernels' gate sends to the plain bounce (A7); the backward
    kernel refuses the teapot (triangles, media and specular materials
    alike), and the train step gives it the hybrid backward instead."""
    scene, cam = _teapot()[3:5]
    require_covered(scene, SceneFlags.of(scene))
    mesh_med = dataclasses.replace(
        scene, med_kind=torch.full_like(scene.med_kind, 2))
    require_covered(mesh_med, SceneFlags.of(mesh_med))
    assert not SceneFlags.of(mesh_med).fused_bounce
    with pytest.raises(NotImplementedError, match="hybrid backward"):
        kbb.require_bwd_kernel(scene, SceneFlags.of(scene))
    assert not kbb.bwd_kernel_available(scene, SceneFlags.of(scene))
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           width=4, height=4, spp=1, max_depth=2,
                           device="cpu")
    assert not step.flags.moving
