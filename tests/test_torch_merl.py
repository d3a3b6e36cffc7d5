"""MERL measured BRDFs against the JAX package: the binary reader and
writer, the Rusinkiewicz index and the lookup, a MERL scene's tables, one
plain bounce lane by lane, a small image and the train step's gradient.

No ``.binary`` table ships with the repository: the tests write a seeded
smooth one (``_torch_scenes.merl_table``) with ``write_merl``. The index
truncates three angles, so a direction within rounding of a bin edge may
take the next bin on another backend: the share of such directions is
held to ``contract.MERL_INDEX_MISMATCH``."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_scenes import merl_table

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu import render as jax_render
from srt_tpu.core.rng import RaySampler
from srt_tpu.diff import image_loss as jax_image_loss
from srt_tpu.io import merl as jmerl_io
from srt_tpu.materials import merl as jmerl
from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.render.integrator import bounce_step as jbounce
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu_torch import RenderConfig, convert, render, render_regen
from srt_tpu_torch.diff.inverse import image_loss
from srt_tpu_torch.io import merl as merl_io
from srt_tpu_torch.materials import merl
from srt_tpu_torch.render.integrator import bounce_step
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import MaterialType, SceneFlags
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)

N = merl_io.RES_THETA_H * merl_io.RES_THETA_D * merl_io.RES_PHI_D // 2
CAMERA = dict(lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0),
              vfov=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@functools.lru_cache(maxsize=None)
def _table() -> np.ndarray:
    """The seeded table as ``read_merl`` gives it (scales applied)."""
    scales = np.asarray(merl_io.CHANNEL_SCALES, np.float64)[:, None]
    return (merl_table(5) * scales).astype(np.float32)


def merl_room(b, table, tris: bool = True):
    """A floor, a rect light, a MERL sphere (table 0) and, with ``tris``,
    a MERL box as 12 triangles (table 1, a darker copy), built the same
    way by either package's builder."""
    light = b.diffuse_light(b.constant((15.0, 15.0, 15.0)))
    floor = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    m0 = b.merl(table, (1.0, 0.9, 0.8))
    m1 = b.merl(0.5 * table, (0.6, 0.7, 0.9))
    b.xz_rect(0, 555, 0, 555, 0, floor)
    lid = b.xz_rect(213, 343, 227, 332, 554, light, flip=True)
    b.sphere((190, 120, 250), 120.0, m0)
    if tris:
        b.box((330, 0, 200), (470, 160, 340), m1, as_tris=True)
    b.light_rect(lid)
    return b


@functools.lru_cache(maxsize=None)
def _scenes(tris: bool = True):
    scene_j = merl_room(JaxSceneBuilder(), _table(), tris).build()
    scene = merl_room(SceneBuilder(), _table(), tris).build("cpu")
    cam_j = JaxCamera.look_at(**CAMERA)
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    return scene_j, cam_j, scene, cam


def test_merl_round_trip_matches_jax(tmp_path):
    """The port's writer writes JAX's bytes; both readers give the scaled
    table; the retro-reflection direction reads index 0 (``brdf.h:
    200-208``)."""
    raw = np.random.default_rng(0).uniform(0.0, 10.0, (3, N))
    mine, theirs = tmp_path / "port.binary", tmp_path / "jax.binary"
    merl_io.write_merl(str(mine), raw)
    jmerl_io.write_merl(str(theirs), raw)
    assert mine.read_bytes() == theirs.read_bytes()
    table = merl_io.read_merl(str(mine))
    assert table.dtype == np.float32 and table.shape == (3, N)
    assert np.array_equal(table, jmerl_io.read_merl(str(mine)))
    scales = np.asarray(merl_io.CHANNEL_SCALES)[:, None]
    np.testing.assert_allclose(table, raw * scales, rtol=1e-5)
    z = torch.tensor([[0.0, 0.0, 1.0]])
    val = merl.lookup(torch.from_numpy(table)[None], torch.tensor([0]), z, z)
    np.testing.assert_array_equal(val[0].numpy(), table[:, 0])


def test_merl_bad_dims(tmp_path):
    bad = tmp_path / "bad.binary"
    np.asarray([2, 2, 2], np.int32).tofile(str(bad))
    with pytest.raises(ValueError, match="MERL grid"):
        merl_io.read_merl(str(bad))
    short = tmp_path / "short.binary"
    with open(short, "wb") as f:
        np.asarray([90, 90, 180], np.int32).tofile(f)
        np.zeros(10, np.float64).tofile(f)
    with pytest.raises(ValueError, match="truncated"):
        merl_io.read_merl(str(short))


def _directions(n: int, seed: int) -> tuple:
    """``n`` seeded pairs of upper-hemisphere unit directions, the first
    64 pairs edge cases: equal directions (theta_d 0), the normal, grazing
    and mirrored pairs."""
    r = np.random.default_rng(seed)
    v = r.standard_normal((2, n, 3)).astype(np.float32)
    v[..., 2] = np.abs(v[..., 2])
    v[1, :16] = v[0, :16]
    v[:, 16:24] = (0.0, 0.0, 1.0)
    v[:, 24:40, 2] = 1e-4
    v[1, 40:64] = v[0, 40:64] * (-1.0, -1.0, 1.0)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v[0], v[1]


def test_indices_and_lookup_match_jax():
    """``half_diff_indices`` against JAX's on 2^18 direction pairs: the
    share that differs within ``MERL_INDEX_MISMATCH``; ``lookup`` from two
    stacked tables equal to JAX's where the index agrees."""
    wo, wi = _directions(1 << 18, 1)
    got = merl.half_diff_indices(torch.from_numpy(wo), torch.from_numpy(wi))
    want = np.asarray(jmerl.half_diff_indices(jnp.asarray(wo),
                                              jnp.asarray(wi)))
    assert got.dtype == torch.int32
    same = got.numpy() == want
    assert (~same).mean() <= contract.MERL_INDEX_MISMATCH, (~same).sum()
    assert got.min() >= 0 and got.max() < N
    tables = np.stack([_table(), 0.5 * _table()])
    tid = np.random.default_rng(2).integers(0, 2, wo.shape[0]).astype(
        np.int32)
    val = merl.lookup(torch.from_numpy(tables), torch.from_numpy(tid),
                      torch.from_numpy(wo), torch.from_numpy(wi)).numpy()
    val_j = np.asarray(jmerl.lookup(jnp.asarray(tables), jnp.asarray(tid),
                                    jnp.asarray(wo), jnp.asarray(wi)))
    assert np.array_equal(val[same], val_j[same])


def test_merl_scene_tables_match_jax():
    """``SceneBuilder.merl`` stacks the tables and stores each one's index
    as parameter 0, as JAX's builder does; the flags keep the scene off
    the bounce kernels, as JAX's gate does."""
    scene_j, _, scene, _ = _scenes()
    want = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    for k in ("merl", "mat_type", "mat_params", "mat_tex", "tex_color",
              "tri_p0", "tri_mat", "bvh_skip", "sph_mat"):
        a, b = getattr(scene, k), getattr(want, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert scene.merl.shape == (2, 3, N)
    mt = scene.mat_type.tolist()
    assert mt.count(int(MaterialType.MERL)) == 2
    flags, flags_j = SceneFlags.of(scene), JaxSceneFlags.of(scene_j)
    assert not flags.fused_bounce and not flags_j.fused_bounce


def _primary_state(cam_j, n: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    pix = r.integers(0, 64 * 64, n).astype(np.int32)
    samp = r.integers(0, 4, n).astype(np.int32)
    s, t = (r.uniform(size=n).astype(np.float32) for _ in range(2))
    sampler = RaySampler.create(0, pix, samp)
    ray = cam_j.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                     sampler.uniform(34))
    return {k: np.asarray(v) for k, v in dict(
        o=ray.origin, d=ray.direction, time=ray.time,
        beta=np.ones((n, 3), np.float32),
        radiance=np.zeros((n, 3), np.float32), alive=np.ones(n, bool),
        salt=sampler.salt, depth=np.zeros(n, np.int32)).items()}


def test_merl_bounce_matches_xla(flush_denormals):
    """The plain bounce on the MERL room against JAX's jitted XLA
    ``bounce_step``, 4,096 lanes over three bounces along JAX's
    trajectory, under the per-bounce contract; the MERL lanes shade."""
    scene_j, cam_j, scene, _ = _scenes()
    flags_j, flags = JaxSceneFlags.of(scene_j), SceneFlags.of(scene)
    state = _primary_state(cam_j, 4096, 0)
    step = jax.jit(functools.partial(jbounce, max_depth=8, rr_start=1 << 30,
                                     flags=flags_j))
    for _ in range(3):
        a = {k: np.asarray(v) for k, v in step(scene_j, state).items()}
        st = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
        st["salt"] = torch.from_numpy(state["salt"].astype(np.int64))
        b = bounce_step(scene, st, 8, 1 << 30, flags)
        contract.check_bounce(a, {k: v.numpy() for k, v in b.items()})
        np.testing.assert_array_equal(b["depth"].numpy(), a["depth"])
        state = a


def test_merl_image_matches_jax():
    """A 16x16, 2 spp, depth 4 image of the MERL room through either of
    the port's engines (the plain bounce, the walk B3's plain version)
    against JAX's scan engine, under the image contract."""
    scene_j, cam_j, scene, cam = _scenes()
    cfg = dict(width=16, height=16, spp=2, max_depth=4)
    want = np.asarray(jax_render(scene_j, cam_j, JaxRenderConfig(**cfg)))
    img, m = render(scene, cam, RenderConfig(**cfg), metrics=True)
    assert (m.bounce, m.walk) == ("plain", "B3")
    contract.check_image(img.numpy(), want)
    contract.check_image(render_regen(scene, cam, RenderConfig(**cfg))
                         .numpy(), want)
    assert float(img.mean()) > 0.0


def test_merl_gradient_matches_jax(monkeypatch):
    """The loss and its gradient in the texture colours (the MERL albedo
    tints among them) on the MERL room without its triangles (JAX cannot
    differentiate a triangle walk on the CPU, C11) against ``jax.grad``
    of JAX's ``image_loss`` on its XLA bounce: the albedo multiplies the
    table's value, whose sampled direction no gradient moves, so the
    detached BSDF sample of JAX's bounce (C12) does not enter; the loss
    within 1e-4 relative, the gradient within rtol 2e-3 plus 1e-6."""
    monkeypatch.setenv("SRT_TPU_PALLAS", "off")
    jax.clear_caches()
    scene_j, cam_j, scene, cam = _scenes(tris=False)
    size = dict(width=8, height=8, spp=2, max_depth=3)
    n = size["width"] * size["height"]
    target = np.full((n, 3), 0.3, np.float32)
    kw = dict(wavefront=64, depth_budget=2.0, drain=2)
    loss_j, g_j = jax.value_and_grad(lambda p: jax_image_loss(
        p, scene_j, cam_j, target, jnp.arange(n, dtype=jnp.int32), seed=3,
        engine_kw=kw, **size))({"tex_color": scene_j.tex_color})
    tc = scene.tex_color.clone().requires_grad_()
    loss = image_loss({"tex_color": tc}, scene, cam, torch.from_numpy(target),
                      torch.arange(n), seed=3, engine_kw=kw, **size)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-4 * float(loss_j)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(g_j["tex_color"]),
                               rtol=2e-3, atol=1e-6)
    merl_tex = scene.mat_tex[scene.mat_type == int(MaterialType.MERL)]
    assert float(tc.grad[merl_tex.long()].abs().sum()) > 0.0
