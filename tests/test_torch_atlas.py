"""Image-atlas gradients (the float atlas) against the JAX package.

An image texture's atlas is float32; the builder packs an rgb8 twin
(``atlas_u32``) when every value is a u8/255 multiple, and the kernels
read that twin. Optimising the atlas drops the twin (``splice``), so every
lookup reads the float atlas, whose gathers carry the texels' cotangents.
Held here on the CPU: the float lookup against JAX's ``_image_value``;
a float atlas of u8/255 values rendering the packed atlas's bits; the
``{"atlas"}`` gradient against ``jax.grad`` of JAX's ``image_loss`` and
against finite differences; the gates and the launch arguments. On the
card ``tests/test_torch_kernel.py::test_float_atlas_matches_packed_on_gpu``
and ``chip_smoke.py`` phase 31 hold B1, B2 and B5 to the packed bits."""
from __future__ import annotations

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.diff import image_loss as jax_image_loss
from srt_tpu.materials.textures import _image_value as jax_image_value
from srt_tpu.scene import library as jlib
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu_torch import RenderConfig, convert, render, render_regen
from srt_tpu_torch.diff import splice
from srt_tpu_torch.diff.inverse import (image_loss, make_train_step,
                                        render_pixels)
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.kernels import bounce_vjp as kv
from srt_tpu_torch.materials.textures import image_value
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import SceneFlags, require_covered, \
    require_trainable

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:asset .* missing")

SIZE = dict(width=8, height=8, spp=2, max_depth=3)
ENGINE = dict(wavefront=64, depth_budget=2.0, drain=2)


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _arrays(scene_j) -> dict:
    return {k: (None if v is None else np.asarray(v))
            for k, v in scene_j._asdict().items()}


@functools.lru_cache(maxsize=None)
def _earth():
    """earth_sphere from JAX's library (its atlas the 8x8 stand-in, u8/255
    values, so packed) and the port's copy of its tables."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene_j, cam_j, _ = jlib.get_scene("earth_sphere")
    scene = convert.scene_from_arrays(_arrays(scene_j), device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    return scene_j, cam_j, scene, cam


def _float_images(b):
    """Two float images (values not u8/255, so no packed twin) on a
    Lambertian sphere and an emitter, and a floor; the builder."""
    r = np.random.default_rng(9)
    a = b.image(r.uniform(0, 1, (5, 7, 3)).astype(np.float32))
    e = b.image(r.uniform(0, 4, (3, 4, 3)).astype(np.float32))
    b.sphere((0, 1, 0), 1.0, b.lambertian(a))
    b.light_sphere(b.sphere((2, 3, 1), 0.7, b.diffuse_light(e)))
    b.xz_rect(-5, 5, -5, 5, 0, b.lambertian(b.constant((0.5, 0.5, 0.5))))
    return b


def test_float_lookup_matches_jax():
    """The float atlas lookup of both builders' tables (no packed twin)
    equal to JAX's ``_image_value`` to the bit, uv out of range included;
    on the packed earth_sphere, the float and packed lookups agree."""
    scene_j = _float_images(JaxSceneBuilder()).build()
    scene = _float_images(SceneBuilder()).build("cpu")
    assert scene.atlas_u32 is None and scene_j.atlas_u32 is None
    assert torch.equal(scene.atlas, torch.from_numpy(np.asarray(
        scene_j.atlas)))
    r = np.random.default_rng(1)
    n = 4096
    tex = np.where(r.random(n) < 0.5, 0, 1).astype(np.int32)
    tex = np.asarray([int(t) for t in np.flatnonzero(
        np.asarray(scene_j.tex_type) == 3)])[tex]
    u, v = (r.uniform(-0.2, 1.2, n).astype(np.float32) for _ in range(2))
    got = image_value(scene, torch.from_numpy(tex), torch.from_numpy(u),
                      torch.from_numpy(v))
    want = np.asarray(jax_image_value(scene_j, jnp.asarray(tex),
                                      jnp.asarray(u), jnp.asarray(v)))
    assert np.array_equal(got.numpy(), want)
    _, _, earth, _ = _earth()
    flt = splice(earth, {"atlas": earth.atlas})
    tex = torch.full((n,), int(torch.nonzero(earth.tex_type == 3)[0]))
    args = (tex, torch.from_numpy(u), torch.from_numpy(v))
    assert torch.equal(image_value(earth, *args), image_value(flt, *args))


@pytest.mark.parametrize("engine", ["regen", "scan"])
def test_float_atlas_renders_the_packed_bits(engine):
    """earth_sphere (an emitting image) and a room with image albedo,
    their atlases spliced to float: both engines' images equal to the
    packed atlas's to the bit."""
    from _torch_scenes import LIT_ROOM_CAMERA, lit_room_media

    from srt_tpu_torch.render.camera import Camera
    _, _, earth, cam = _earth()
    room = lit_room_media(SceneBuilder()).build("cpu")
    room_cam = Camera.look_at(**LIT_ROOM_CAMERA, device="cpu")
    fn = render_regen if engine == "regen" else render
    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=4)
    for scene, c in ((earth, cam), (room, room_cam)):
        assert scene.atlas_u32 is not None
        flt = splice(scene, {"atlas": scene.atlas})
        img = fn(flt, c, cfg)
        assert torch.equal(img, fn(scene, c, cfg)) and img.mean() > 0


def test_atlas_gradient_matches_jax(flush_denormals, monkeypatch):
    """The loss and the ``{"atlas"}`` gradient on earth_sphere at 8x8,
    2 spp, depth 3 against ``jax.value_and_grad`` of JAX's ``image_loss``
    (its XLA bounce, ``SRT_TPU_PALLAS=off``). The atlas is the emitter's:
    its texels enter a lane's radiance through the emission it sees or
    samples, through no sampled direction, so JAX's detached BSDF sample
    (C12) does not enter and every lane is compared, the light-sampled
    ones among them. Loss within 1e-4 relative, gradient within rtol
    2e-3 plus 1e-6 (``test_torch_train.py``'s bounds)."""
    monkeypatch.setenv("SRT_TPU_PALLAS", "off")
    jax.clear_caches()
    scene_j, cam_j, scene, cam = _earth()
    n = SIZE["width"] * SIZE["height"]
    target = np.full((n, 3), 0.3, np.float32)
    loss_j, g_j = jax.value_and_grad(lambda p: jax_image_loss(
        p, scene_j, cam_j, target, jnp.arange(n, dtype=jnp.int32), seed=5,
        engine_kw=ENGINE, **SIZE))({"atlas": scene_j.atlas})
    params = convert.params_from_arrays({"atlas": np.asarray(scene_j.atlas)},
                                        device="cpu")
    atlas = params["atlas"].requires_grad_()
    loss = image_loss({"atlas": atlas}, scene, cam, torch.from_numpy(target),
                      torch.arange(n), seed=5, engine_kw=ENGINE, **SIZE)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-4 * float(loss_j)
    want = np.asarray(g_j["atlas"])
    np.testing.assert_allclose(atlas.grad.numpy(), want, rtol=2e-3,
                               atol=1e-6)
    assert int((np.abs(want) > 0).sum()) >= 30


def test_atlas_gradient_matches_finite_differences(flush_denormals):
    """Central differences of the port's own loss (common random numbers)
    on the four texels with the largest gradient, each channel: within
    3e-3 plus 5% of the difference quotient (``test_torch_train.py``'s
    bound)."""
    _, _, scene, cam = _earth()
    pix = torch.arange(SIZE["width"] * SIZE["height"])
    with torch.no_grad():
        target = 0.5 * render_pixels(scene, cam, pix, seed=99, **SIZE)

    def loss(atlas):
        return image_loss({"atlas": atlas}, scene, cam, target, pix, seed=7,
                          engine_kw=ENGINE, **SIZE)

    a = scene.atlas.clone().requires_grad_()
    loss(a).backward()
    g = a.grad.numpy()
    texels = np.argsort(np.abs(g.reshape(-1, 3)).sum(1))[-4:]
    for t in texels:
        for c in range(3):
            i = 3 * int(t) + c
            d = torch.zeros_like(scene.atlas)
            d[i] = 0.05
            with torch.no_grad():
                q = (float(loss(scene.atlas + d))
                     - float(loss(scene.atlas - d))) / 0.1
            assert abs(q - g[i]) < 3e-3 + 0.05 * abs(q), (t, c, q, g[i])


def test_splice_and_gates_accept_the_atlas():
    """``splice`` drops the packed twin, as JAX's does; the coverage and
    train gates admit a float atlas; B5 is exact for it unless it requires
    a gradient, and then the train step's bounce takes the hybrid, which
    differentiates it; the train step runs and moves the atlas."""
    _, _, scene, cam = _earth()
    flt = splice(scene, {"atlas": scene.atlas})
    assert flt.atlas_u32 is None and torch.equal(flt.atlas, scene.atlas)
    flags = SceneFlags.of(flt)
    require_covered(flt, flags)
    require_trainable(flt, flags)
    assert kbb.bwd_kernel_available(flt, flags)
    grad = dataclasses.replace(flt, atlas=flt.atlas.clone().requires_grad_())
    assert not kbb.bwd_kernel_available(grad, flags)
    with pytest.raises(NotImplementedError, match="image atlas"):
        kbb.require_bwd_kernel(grad, flags)
    assert list(kv.geometric_params(grad)) == ["atlas"]
    step = make_train_step(scene, cam, {"atlas": scene.atlas}, device="cpu",
                           engine_kw=ENGINE, **SIZE)
    before = step.params["atlas"].detach().clone()
    assert torch.isfinite(step(torch.full((8, 8, 3), 0.3), 0))
    assert not torch.equal(step.params["atlas"].detach(), before)
    for engine in ("regen", "scan"):
        step = make_train_step(flt, cam, {"tex_color": flt.tex_color},
                               device="cpu", engine=engine, **SIZE)
        assert torch.isfinite(step(torch.full((8, 8, 3), 0.3), 0))


def test_atlas_launch_arguments():
    """The kernels' atlas fields: the packed twin's texels, or the float
    atlas's with ``atlas_f32``; 0 texels only without an image, and a
    table that does not match the scene raises."""
    _, _, scene, _ = _earth()
    flags = SceneFlags.of(scene)
    packed = kb.atlas_args(scene, kb.build_tables(scene, flags))
    flt = splice(scene, {"atlas": scene.atlas})
    floats = kb.atlas_args(flt, kb.build_tables(flt, flags))
    assert (packed["n_atlas"], packed["atlas_f32"]) == (
        scene.atlas_u32.shape[0], 0)
    assert (floats["n_atlas"], floats["atlas_f32"]) == (
        scene.atlas.shape[0] // 3, 1)
    none = dataclasses.replace(scene, atlas=scene.atlas[:0], atlas_u32=None)
    assert kb.atlas_args(none, kb.build_tables(none, flags))["n_atlas"] == 0
    with pytest.raises(ValueError, match="atlas table"):
        kb.atlas_args(scene, kb.build_tables(none, flags))


def test_convert_carries_the_float_atlas_and_merl():
    """``convert`` carries a float atlas (no twin), the MERL tables and an
    ``{"atlas"}`` parameter across from JAX's tables unchanged."""
    scene_j = _float_images(JaxSceneBuilder()).build()
    scene = convert.scene_from_arrays(_arrays(scene_j), device="cpu")
    assert scene.atlas_u32 is None
    assert torch.equal(scene.atlas, torch.from_numpy(np.asarray(
        scene_j.atlas)))
    assert tuple(scene.merl.shape) == tuple(scene_j.merl.shape)
    p = convert.params_from_arrays({"atlas": np.asarray(scene_j.atlas)},
                                   device="cpu")
    assert p["atlas"].dtype == torch.float32
    assert torch.equal(p["atlas"], scene.atlas)
