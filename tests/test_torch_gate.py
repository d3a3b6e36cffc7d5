"""The rest of the render gate (ROADMAP A7) against the JAX package, on
the CPU: the scenes the bounce kernels' gate refuses render through both
engines with the plain bounce, as the JAX package renders them with its
XLA bounce.

- Mesh-bounded media (``SceneBuilder.medium_mesh``, the crossings of
  ``render/integrator.py:mesh_medium_crossings``): the box of
  ``tests/test_render.py:192-220`` as 12 triangles, seen from outside and
  from inside the volume, against JAX's ``render`` and ``render_regen``,
  and against the analytic box medium (the same crossings, so the same
  random streams: JAX's bound, 1e-3).
- A scene past the caps: cornell_boxes with its back wall tiled into 64
  rects (69 rects), against JAX's ``render_regen`` and ``render``, and
  against cornell_boxes itself; the walk stays B3.
- Roulette (``rr_start=2``) on ball_scenes, on earth_sphere (an image
  texture, on its emitter) and on two_perlin_spheres, whose noise albedo
  JAX's gate keeps off its fused kernel under roulette (deferred albedo):
  the port's bounce kernel multiplies the albedo in before the survival
  test, as JAX's XLA bounce does, so its route keeps B2 (B1 in the
  regeneration engine) and both engines agree with both of JAX's. On
  ball_scenes JAX
  runs op by op: roulette's 1/q weights carry the near-mirror spheres'
  FMA flips of its jitted engine (ROADMAP C5) past the contract's mean
  (|Δmean| 0.0037 at 16x16; the op-by-op image is the port's to the bit).

Images under ``utils/contract.py``'s image contract (35% of pixels on
ball_scenes against JAX's jitted engines, C5). XLA's CPU backend flushes
float32 denormals, so the port's runs here do too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch
from _torch_parity import scenes
from _torch_scenes import (CORNELL_CAMERA, MEDIUM_CAMERA,
                           MEDIUM_CAMERA_INSIDE, cornell_tiled, medium_room)

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu import render as jax_render
from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.render.regen import render_regen as jax_render_regen
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu_torch import (RenderConfig, convert, get_scene, make_train_step,
                           render, render_regen)
from srt_tpu_torch.scene.ir import SceneFlags, require_covered
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)

CFG = dict(width=16, height=16, spp=2, max_depth=4, sample_chunk=2,
           pixel_chunk=128)


@pytest.fixture(scope="module", autouse=True)
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _both(fill, camera: dict):
    """(JAX scene, JAX camera, port scene, port camera) of a scene that
    ``fill`` builds into either package's builder."""
    scene_j = fill(JaxSceneBuilder()).build()
    cam_j = JaxCamera.look_at(**camera)
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    return scene_j, cam_j, scene, cam


def _engines(scene_j, cam_j, scene, cam, cfg: dict, op_by_op=False):
    """Each engine's image in both packages and the port's metrics:
    ``{engine: (jax image, port image, port metrics)}``; ``op_by_op``
    runs JAX without jit, so XLA contracts no multiply-add (C5)."""
    out = {}
    for engine, jfn, fn in (("scan", jax_render, render),
                            ("regen", jax_render_regen, render_regen)):
        eager = jax.disable_jit() if op_by_op else contextlib.nullcontext()
        with warnings.catch_warnings(), eager:
            warnings.simplefilter("ignore")
            img_j = np.asarray(jfn(scene_j, cam_j, JaxRenderConfig(**cfg)))
        img, m = fn(scene, cam, RenderConfig(**cfg), metrics=True)
        out[engine] = (img_j, img.numpy(), m)
    return out


MEDIUM_CFG = dict(width=16, height=16, spp=32, max_depth=6, sample_chunk=32)


@pytest.mark.parametrize("where", ["outside", "inside"])
def test_mesh_medium_matches_jax(where):
    camera = MEDIUM_CAMERA if where == "outside" else MEDIUM_CAMERA_INSIDE
    scene_j, cam_j, scene, cam = _both(lambda b: medium_room(b, "mesh"),
                                       camera)
    flags = SceneFlags.of(scene)
    assert flags.mesh_media and not flags.fused_bounce
    assert scene.med_tri_p0.shape == (12, 3)
    assert torch.equal(scene.med_tri_mid, torch.zeros(12, dtype=torch.int32))
    imgs = _engines(scene_j, cam_j, scene, cam, MEDIUM_CFG)
    for engine, (img_j, img, m) in imgs.items():
        assert (m.bounce, m.walk) == ("plain", None), engine
        contract.check_image(img, img_j)
        assert img.mean() > 0.01
    contract.check_image(imgs["scan"][1], imgs["regen"][1])
    # the analytic box medium: the same crossings, the same streams
    _, _, box, _ = _both(lambda b: medium_room(b, "box"), camera)
    assert SceneFlags.of(box).fused_bounce
    np.testing.assert_allclose(
        imgs["scan"][1], render(box, cam, RenderConfig(**MEDIUM_CFG)).numpy(),
        rtol=1e-3, atol=1e-3)


def test_mesh_crossings_chunk_by_lanes(monkeypatch):
    """A lane's crossings do not depend on how many lanes share a chunk."""
    from srt_tpu_torch.render import integrator
    _, _, scene, cam = _both(lambda b: medium_room(b, "mesh"), MEDIUM_CAMERA)
    r = np.random.default_rng(3)
    o = torch.from_numpy((r.standard_normal((300, 3)) * 6).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        r.standard_normal((300, 3)).astype(np.float32)), dim=1)
    whole = integrator.mesh_medium_crossings(scene, o, d, 0)
    monkeypatch.setattr(integrator, "MESH_PAIRS", 7 * 12)
    parts = integrator.mesh_medium_crossings(scene, o, d, 0)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
    assert whole[2].any() and not whole[2].all()


def test_past_the_caps_matches_jax():
    scene_j, cam_j, scene, cam = _both(cornell_tiled, CORNELL_CAMERA)
    assert scene.n_rects == 69
    assert not SceneFlags.of(scene).fused_bounce
    imgs = _engines(scene_j, cam_j, scene, cam, CFG)
    _, _, boxes, boxes_cam = scenes("cornell_boxes")
    reference = render(boxes, boxes_cam, RenderConfig(**CFG)).numpy()
    for engine, (img_j, img, m) in imgs.items():
        assert (m.bounce, m.walk) == ("plain", "B3"), engine
        contract.check_image(img, img_j)
        contract.check_image(img, reference)


@pytest.mark.parametrize("name", ["ball_scenes", "earth_sphere",
                                  "two_perlin_spheres"])
def test_roulette_matches_jax(name):
    """The roulette estimator on a lean scene, an image texture and
    deferred (noise) albedo: the port's route keeps its kernels, both of
    its engines agree with both of JAX's."""
    scene_j, cam_j, scene, cam = scenes(name)
    flags = SceneFlags.of(scene)
    assert flags.fused_deferred_albedo == (name == "two_perlin_spheres")
    assert flags.fused_bounce
    eager = name == "ball_scenes"
    cfg = dict(CFG, max_depth=6, rr_start=2,
               **(dict(width=8, height=8) if eager else {}))
    imgs = _engines(scene_j, cam_j, scene, cam, cfg, op_by_op=eager)
    assert imgs["scan"][2].bounce == "B2"
    assert imgs["regen"][2].bounce == "B1"
    for img_j, img, _ in imgs.values():
        for other_j, _, _ in imgs.values():
            contract.check_image(img, other_j)
    # roulette changed the image, but on earth_sphere, whose paths end on
    # the emitter or in the black sky before bounce 2
    no_rr = render(scene, cam, RenderConfig(**dict(cfg, rr_start=1 << 30)))
    assert (torch.equal(no_rr, torch.from_numpy(imgs["scan"][1]))
            == (name == "earth_sphere"))


def test_gate_refuses_only_merl_and_wide_atlases():
    """``require_covered`` refuses MERL (A12) and atlases that are not
    8-bit (A13); mesh media and scenes past the caps pass."""
    scene, _, _ = get_scene("earth_sphere", device="cpu")
    require_covered(scene, SceneFlags.of(scene))
    mt = scene.mat_type.clone()
    mt[-1] = 7
    merl = dataclasses.replace(scene, mat_type=mt, merl=torch.zeros((1, 3, 1)))
    with pytest.raises(NotImplementedError, match="A12"):
        require_covered(merl, SceneFlags.of(merl))
    wide = dataclasses.replace(scene, atlas_u32=None)
    with pytest.raises(NotImplementedError, match="A13"):
        require_covered(wide, SceneFlags.of(wide))
    for fill, camera in ((lambda b: medium_room(b, "mesh"), MEDIUM_CAMERA),
                         (cornell_tiled, CORNELL_CAMERA)):
        _, _, other, _ = _both(fill, camera)
        require_covered(other, SceneFlags.of(other))


@pytest.mark.parametrize("engine", ["regen", "scan"])
def test_train_step_on_the_plain_route(engine):
    """The train step on a scene the gate refuses differentiates the plain
    bounce: on the mesh medium (its albedo texture) with either engine,
    a finite loss and a finite, nonzero gradient."""
    _, _, scene, cam = _both(lambda b: medium_room(b, "mesh"), MEDIUM_CAMERA)
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           width=8, height=8, spp=2, max_depth=4,
                           engine=engine, device="cpu")
    tc = step.params["tex_color"]
    before = tc.detach().clone()
    loss = step(torch.full((8, 8, 3), 0.3), 0)
    assert torch.isfinite(loss)
    assert torch.isfinite(tc).all() and not torch.equal(tc.detach(), before)
