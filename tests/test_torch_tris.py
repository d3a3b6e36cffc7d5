"""Triangle scenes in srt_tpu_torch against the JAX package: the BVH
builder, the ``cornell_boxes`` tables, the plain version of kernel B3 (the
skip-link walk), the plain version of kernel B2 with a triangle hit, the
``cornell_boxes`` image, and the gates.

Inputs come from numpy with fixed seeds. Tolerances:

* BVH and scene tables: bit for bit.
* The walk: the hit mask and the triangle index equal; ``t`` within 2e-5
  and ``u, v`` within 1e-4 (JAX's own bounds between its XLA walk and its
  kernel, ``tests/test_pallas.py:35-50``). No near-tie mismatch needed
  allowing: on these inputs none occurs.
* The bounce: the per-bounce contract of ``srt_tpu_torch.utils.contract``.
* The image: the contract's image bounds unloosened; ``cornell_boxes``
  has Lambertian walls and boxes only, no near-mirror Beckmann lobe that
  turns XLA's FMA contraction into resampled paths (ROADMAP C5); 0.9% of
  pixels differ beyond 1e-2 at 32x32, 4 spp, depth 6.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu.accel.bvh import build_bvh as jax_build_bvh
from srt_tpu.core.ray import Ray
from srt_tpu.core.rng import RaySampler
from srt_tpu.pallas.bounce import fused_bounce
from srt_tpu.pallas.intersect import intersect_tris_pallas
from srt_tpu.render.intersect import intersect_tris as jax_intersect_tris
from srt_tpu.render.regen import render_regen as jax_render_regen
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu.scene.library import cornell_boxes as jax_cornell_boxes
from srt_tpu_torch import (RenderConfig, convert, get_scene, make_train_step,
                           render_regen)
from srt_tpu_torch.accel.bvh import build_bvh
from srt_tpu_torch.diff.inverse import render_pixels
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.render.intersect import intersect_tris, tri_hit
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import (PORT_FLAGS, MaterialType, SceneFlags,
                                    TextureType, TorchScene,
                                    require_covered, require_trainable)
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)


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
def _cornell():
    """(JAX scene, JAX camera, port scene, port camera), the port's built
    by its own library."""
    scene_j, cam_j, _ = jax_cornell_boxes(aspect=1.0)
    scene, cam, _ = get_scene("cornell_boxes", device="cpu")
    return scene_j, cam_j, scene, cam


def _soup(t: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((t, 3, 3)) \
        .astype(np.float32)


def _degenerate() -> np.ndarray:
    # identical triangles: every split takes the median fallback
    return np.tile(np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]],
                            np.float32), (33, 1, 1))


def _cornell_tris() -> np.ndarray:
    s = _cornell()[2]
    return torch.stack([s.tri_p0, s.tri_p1, s.tri_p2], 1).numpy()


@pytest.mark.parametrize("verts", [
    pytest.param(lambda: _soup(37), id="soup37"),
    pytest.param(lambda: _soup(300, 1), id="soup300"),
    pytest.param(_degenerate, id="degenerate"),
    pytest.param(_cornell_tris, id="cornell_boxes")])
def test_bvh_matches_jax_bit_for_bit(verts):
    v = verts()
    got, order = build_bvh(v)
    want, order_j = jax_build_bvh(v)
    np.testing.assert_array_equal(order, order_j)
    for k in got._fields:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert sorted(order.tolist()) == list(range(len(v)))


def test_cornell_boxes_tables_bit_equal():
    scene_j, cam_j, scene, cam = _cornell()
    want = convert.scene_from_arrays(_arrays(scene_j), device="cpu")
    for f in dataclasses.fields(TorchScene):
        a, b = getattr(scene, f.name), getattr(want, f.name)
        if a is None and b is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert torch.equal(a, b), f.name
    assert scene.n_tris == 24 and scene.n_rects == 6 and scene.n_spheres == 0
    # scene_from_arrays carries every field, the BVH included
    back = convert.scene_from_arrays(
        {f.name: getattr(scene, f.name).numpy()
         for f in dataclasses.fields(TorchScene)
         if getattr(scene, f.name) is not None}, device="cpu")
    for f in dataclasses.fields(TorchScene):
        a = getattr(scene, f.name)
        assert (a is None) == (getattr(back, f.name) is None), f.name
        assert a is None or torch.equal(a, getattr(back, f.name)), f.name
    flags = SceneFlags.of(scene)
    want_flags = JaxSceneFlags.of(scene_j)._asdict()
    shared = [k for k in flags._fields if k not in PORT_FLAGS]
    assert ({k: getattr(flags, k) for k in shared}
            == {k: want_flags[k] for k in shared})
    assert not flags.mesh_media
    rec_j = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()},
        device="cpu").record()
    np.testing.assert_allclose(cam.record().numpy(), rec_j.numpy(),
                               rtol=1e-6, atol=1e-6)


def _soup_case(t: int, n: int):
    """A JAX scene holding a random soup and random rays through it (the
    inputs of ``tests/test_pallas.py:19-33``)."""
    from srt_tpu.io.mesh import TriMesh
    from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
    rng = np.random.default_rng(0)
    b = JaxSceneBuilder()
    mat = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    b.trimesh(TriMesh(positions=rng.standard_normal((t, 3, 3))
                      .astype(np.float32), uvs=None, normals=None), mat)
    o = rng.standard_normal((n, 3)).astype(np.float32) * 3
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return b.build(), o, d


def _camera_case(n: int):
    """``cornell_boxes`` and camera rays through random film points."""
    scene_j, cam_j, _, _ = _cornell()
    r = np.random.default_rng(7)
    s, t = (r.uniform(size=n).astype(np.float32) for _ in range(2))
    sampler = RaySampler.create(0, r.integers(0, 1 << 18, n).astype(np.int32),
                                np.zeros(n, np.int32))
    ray = cam_j.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                     sampler.uniform(34))
    return scene_j, np.asarray(ray.origin), np.asarray(ray.direction)


@pytest.mark.parametrize("case", [
    pytest.param(lambda: _soup_case(37, 257), id="soup37"),
    pytest.param(lambda: _soup_case(300, 2000), id="soup300"),
    pytest.param(lambda: _camera_case(4096), id="cornell_camera")])
def test_walk_matches_jax(case):
    """The plain B3 against JAX's XLA walk and its Pallas kernel in
    interpret mode; the assembled hit against the XLA walk's."""
    scene_j, o, d = case()
    scene = convert.scene_from_arrays(_arrays(scene_j), device="cpu")
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t, u, v, idx, visits, tests = intersect_tris(scene, to, td, 1e-3,
                                                 stats=True)
    ray = Ray(origin=o, direction=d, time=np.zeros(len(o), np.float32))
    hx = jax_intersect_tris(scene_j, ray, 1e-3, 3e38)
    tp, up, vp, ip = (np.asarray(a) for a in
                      intersect_tris_pallas(scene_j, ray, 1e-3,
                                            interpret=True))
    hit = (t < 3e38).numpy()
    np.testing.assert_array_equal(hit, np.asarray(hx.hit))
    np.testing.assert_array_equal(hit, tp < 3e38)
    assert 0.1 < hit.mean()
    np.testing.assert_array_equal(idx.numpy()[hit], ip[hit])
    for got, want, tol in ((t, np.asarray(hx.t), 2e-5), (t, tp, 2e-5),
                           (u, up, 1e-4), (v, vp, 1e-4)):
        np.testing.assert_allclose(got.numpy()[hit], want[hit], rtol=tol,
                                   atol=tol)
    h = tri_hit(scene, to, td, t, u, v, idx)
    np.testing.assert_array_equal(h.mat.numpy()[hit], np.asarray(hx.mat)[hit])
    for a, b in ((h.uv, hx.uv), (h.normal, hx.normal)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-4, atol=1e-4)
    # what the bound counts: every ray visits the root; a hit needs a test
    assert (visits >= 1).all() and (tests.numpy()[hit] >= 1).all()
    # the wrapper takes the plain version on CPU tensors, launching nothing
    launches = ki.LAUNCHES
    got = ki.intersect_tris(scene, ki.pack_tables(scene), to, td)
    assert ki.LAUNCHES == launches
    for a, b in zip(got, (t, u, v, idx)):
        assert torch.equal(a, b)


def test_pack_tables_layout():
    """B3's 16-byte records: a node is lo, skip, hi and the link
    ``first << count_bits | count``; a triangle is p0, p1 - p0, p2 - p0,
    each padded to four words."""
    scene = _cornell()[2]
    tb = ki.pack_tables(scene)
    assert tb["nodes"].shape == (scene.n_bvh_nodes, 8)
    assert tb["tris"].shape == (24, 12)
    words = tb["nodes"].view(torch.int32)
    bits = tb["count_bits"]
    assert torch.equal(words[:, 3], scene.bvh_skip)
    assert torch.equal(words[:, 7] >> bits, scene.bvh_first)
    assert torch.equal(words[:, 7] & ((1 << bits) - 1), scene.bvh_count)
    assert torch.equal(tb["tris"][:, 0:3], scene.tri_p0)
    assert torch.equal(tb["tris"][:, 4:7], scene.tri_p1 - scene.tri_p0)
    assert torch.equal(tb["tris"][:, 8:11], scene.tri_p2 - scene.tri_p0)


def _cornell_state(n: int = 4096) -> dict:
    """A mid-flight ``cornell_boxes`` state: camera rays through random
    film points take two plain bounces, a lane that ends taking the next
    fresh ray after each, as the engine refills; then a seeded half of the
    lanes is marked dead."""
    scene_j, cam_j, scene, _ = _cornell()
    flags = SceneFlags.of(scene)
    r = np.random.default_rng(11)
    m = 3 * n
    pix = r.integers(0, 512 * 512, m).astype(np.int32)
    samp = r.integers(0, 16, m).astype(np.int32)
    s, t = (r.uniform(size=m).astype(np.float32) for _ in range(2))
    sampler = RaySampler.create(0, pix, samp)
    ray = cam_j.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                     sampler.uniform(34))
    pool = dict(o=torch.from_numpy(np.array(ray.origin)),
                d=torch.from_numpy(np.array(ray.direction)),
                time=torch.from_numpy(np.array(ray.time)),
                salt=torch.from_numpy(np.asarray(sampler.salt)
                                      .astype(np.int64)).to(torch.int32))
    st = dict(beta=torch.zeros((n, 3)), radiance=torch.zeros((n, 3)),
              alive=torch.zeros(n, dtype=torch.bool),
              depth=torch.zeros(n, dtype=torch.int32),
              **{k: torch.zeros_like(v[:n]) for k, v in pool.items()})
    spec = kb.StepSpec(max_depth=8)
    mat = kb.build_tables(scene, flags)["mat"]
    cursor = 0
    for i in range(3):
        lanes = torch.nonzero(~st["alive"])[:, 0]
        src = torch.arange(cursor, cursor + len(lanes))
        cursor += len(lanes)
        for k, v in pool.items():
            st[k][lanes] = v[src]
        st["beta"][lanes] = 1.0
        st["radiance"][lanes] = 0.0
        st["depth"][lanes] = 0
        st["alive"][lanes] = True
        if i < 2:
            st = kb.bounce_step_ref(scene, flags, mat, st, spec)
    st["alive"] = st["alive"] & torch.from_numpy(r.random(n) >= 0.5)
    return {k: v.contiguous() for k, v in st.items()}


def test_bounce_with_triangle_hit_matches_fused_bounce(flush_denormals):
    """One bounce of the plain B2 fed the plain B3's hit against JAX's
    ``fused_bounce`` with its external-hit planes (Pallas interpret mode,
    its triangle hit from ``intersect_tris_pallas``), lane by lane."""
    scene_j, _, scene, _ = _cornell()
    flags = SceneFlags.of(scene)
    st = _cornell_state()
    assert 0.4 < float(st["alive"].float().mean()) < 0.6
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=8)
    tri = ki.intersect_tris(scene, ki.pack_tables(scene), st["o"], st["d"])
    launches = kb.LAUNCHES_FWD
    got = kb.bounce_fwd(scene, flags, tables, st, spec, tri)
    assert kb.LAUNCHES_FWD == launches
    state_j = {k: v.numpy() for k, v in st.items()}
    state_j["salt"] = state_j["salt"].view(np.uint32)
    step = jax.jit(functools.partial(
        fused_bounce, max_depth=8, rr_start=1 << 30,
        flags=JaxSceneFlags.of(scene_j), interpret=True))
    want = {k: np.asarray(v) for k, v in step(scene_j, state_j).items()}
    np.testing.assert_array_equal(got["depth"].numpy(), want["depth"])
    m = contract.check_bounce(want, {k: v.numpy() for k, v in got.items()})
    # the triangle hits matter here: lanes that hit a box this bounce
    box = (tri[0] < 3e38) & st["alive"]
    assert int(box.sum()) > 100, m


def test_image_matches_jax(flush_denormals, monkeypatch):
    monkeypatch.delenv("SRT_TPU_PALLAS", raising=False)
    scene_j, cam_j, scene, cam = _cornell()
    cfg = dict(width=32, height=32, spp=4, max_depth=6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        img_j, m_j = jax_render_regen(scene_j, cam_j,
                                      JaxRenderConfig(**cfg), metrics=True)
    img, m = render_regen(scene, cam, RenderConfig(**cfg), metrics=True)
    assert img.shape == (32, 32, 3) and img.dtype == torch.float32
    contract.check_image(img.numpy(), np.asarray(img_j))
    assert m.nan_scrubbed == m_j.nan_scrubbed == 0
    assert abs(m.path_vertices - m_j.path_vertices) < 0.015 * m_j.path_vertices
    assert 0.1 < float(img.mean()) < 0.3


def test_render_dispatches_on_triangles(monkeypatch):
    """A triangle scene runs B3 then B2 once per bounce; a scene without
    triangles runs the B1 loop, untouched by the triangle path."""
    calls = {"b1": 0, "b2": 0, "b3": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kb, "regen_bounce", counted("b1", kb.regen_bounce))
    monkeypatch.setattr(kb, "bounce_fwd", counted("b2", kb.bounce_fwd))
    monkeypatch.setattr(ki, "intersect_tris", counted("b3", ki.intersect_tris))
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=4)
    _, m = render_regen(*_cornell()[2:], cfg, metrics=True)
    assert calls == {"b1": 0, "b2": m.bounces, "b3": m.bounces}
    scene, cam, _ = get_scene("ball_scenes", device="cpu")
    calls.update(b2=0, b3=0)
    _, m = render_regen(scene, cam, cfg, metrics=True)
    assert calls == {"b1": m.bounces, "b2": 0, "b3": 0}


def test_plain_render_equals_default_on_cpu():
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=4)
    scene, cam = _cornell()[2:]
    assert torch.equal(render_regen(scene, cam, cfg),
                       render_regen(scene, cam, cfg, plain=True))


def test_train_step_refuses_triangles():
    """Kernel B5 has no external-hit mode: it refuses a triangle scene
    rather than differentiate it wrong, and the train step gives the scene
    the hybrid backward instead (``kernels.bounce_vjp``), whose gradient
    reaches the colours."""
    scene, cam = _cornell()[2:]
    flags = SceneFlags.of(scene)
    assert not kbb.bwd_kernel_available(scene, flags)
    with pytest.raises(NotImplementedError, match="A13"):
        kbb.require_bwd_kernel(scene, flags)
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           width=4, height=4, spp=1, max_depth=2,
                           device="cpu")
    assert np.isfinite(float(step(torch.full((4, 4, 3), 0.3), 0)))
    assert float(step.params["tex_color"].grad.abs().sum()) > 0.0
    tc = scene.tex_color.clone().requires_grad_()
    img = render_pixels(dataclasses.replace(scene, tex_color=tc), cam,
                        torch.arange(4), width=2, height=2, spp=1,
                        max_depth=2, seed=0)
    img.sum().backward()
    assert torch.isfinite(tc.grad).all()


def _with_material(mtype: int) -> TorchScene:
    scene = _cornell()[2]
    mt = scene.mat_type.clone()
    mt[0] = mtype
    return dataclasses.replace(scene, mat_type=mt)


def _rects_only(scene: TorchScene) -> TorchScene:
    """The scene without its triangles: its bounce would be kernel B1."""
    return dataclasses.replace(scene, tri_p0=scene.tri_p0[:0],
                               tri_p1=scene.tri_p1[:0],
                               tri_p2=scene.tri_p2[:0])


def _mesh_medium(scene: TorchScene) -> TorchScene:
    return dataclasses.replace(
        scene, med_kind=torch.full((1,), 2, dtype=torch.int32))


# the render gate covers metal, dielectric, checker textures and sphere
# or box media on every scene (kernel B1's and B2's rich instantiation),
# and so does the train gate (B5's rich instantiation without triangles,
# the hybrid with them); both admit mesh-bounded media (A7), which the
# bounce kernels' gate sends to the plain bounce
@pytest.mark.parametrize("change,item", [
    pytest.param(_mesh_medium, "A7", id="media"),
    pytest.param(lambda s: _rects_only(
        _with_material(int(MaterialType.METAL))), None, id="metal"),
    pytest.param(lambda s: _rects_only(
        _with_material(int(MaterialType.DIELECTRIC))), None,
        id="dielectric"),
    pytest.param(lambda s: dataclasses.replace(
        s, tex_type=torch.full_like(s.tex_type, int(TextureType.CHECKER))),
        None, id="checker")])
def test_gate_still_refuses(change, item):
    scene = change(_cornell()[2])
    flags = SceneFlags.of(scene)
    require_covered(scene, flags)
    require_trainable(scene, flags)
    if item == "A7":
        assert flags.mesh_media and not flags.fused_bounce
        assert not kbb.bwd_kernel_available(scene, flags)
        return
    assert kbb.bwd_kernel_available(scene, flags) == (not scene.n_tris)
    mesh = _mesh_medium(scene)
    mflags = SceneFlags.of(mesh)
    require_trainable(mesh, mflags)
    assert not mflags.fused_bounce
    assert not kbb.bwd_kernel_available(mesh, mflags)


def test_gate_refuses_parity_on_triangles():
    """The parity estimator renders triangle scenes (B3 then B2's parity
    instantiation), and so does its sequential heap-slot mode on the scan
    engine (A6, which the gate refused before the scan engine was
    ported); ``seq_stale`` sets no flag of its own."""
    from srt_tpu_torch.render.api import RenderConfig, render, scene_flags
    scene, cam = _cornell()[2:4]
    flags = scene_flags(scene, RenderConfig(ref_parity=True))
    assert flags.ref_parity
    require_covered(scene, flags)
    cfg = RenderConfig(width=4, height=4, spp=2, max_depth=3,
                       ref_parity=True, seq_stale=True)
    assert scene_flags(scene, cfg) == flags
    img, m = render(scene, cam, cfg, metrics=True)
    assert torch.isfinite(img).all() and (m.bounce, m.walk) == ("B2", "B3")


def test_builder_box_forms():
    """``box`` as six rects and as twelve triangles, as the JAX builder
    lays them out."""
    from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
    for as_tris in (False, True):
        b, bj = SceneBuilder(), JaxSceneBuilder()
        for x in (b, bj):
            x.box((1, 2, 3), (4, 6, 8), x.lambertian(x.constant((1, 1, 1))),
                  as_tris=as_tris)
        got = b.build("cpu")
        want = convert.scene_from_arrays(_arrays(bj.build()), device="cpu")
        assert got.n_tris == (12 if as_tris else 0)
        assert got.n_rects == (0 if as_tris else 6)
        for f in dataclasses.fields(TorchScene):
            a, c = getattr(got, f.name), getattr(want, f.name)
            assert (a is None and c is None) or torch.equal(a, c), f.name
