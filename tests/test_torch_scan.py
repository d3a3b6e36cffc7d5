"""The port's scan engine against the JAX package's, on the CPU.

``render`` and ``render_tonemapped`` at 16x16, 2 spp, depth 4 with
``sample_chunk`` 2 and ``pixel_chunk`` 128 (so both chunk loops run more
than once) against JAX's ``render`` on ball_scenes and cornell_boxes,
under ``utils/contract.py``'s image contract (35% of pixels on
ball_scenes against JAX's jitted engine: FMA contraction on its
near-mirror spheres, ROADMAP C5), and the bounce histogram of
``metrics=True`` within the contract's alive-mismatch share of the lanes
at every bounce, against JAX run op by op (its jitted run contracts
multiply-adds, which moves a few lanes at this size). The scan image
against the port's own regeneration image; ``seq_stale`` against JAX's
and bit-equal to the parity scan render at ``sample_chunk`` 1 (the carried
plane is inert, ``srt_tpu/pallas/bounce.py:966-970``); and the scan
engine's train step: its loss against JAX's scan loss, its gradient
against central differences of its own loss. XLA's CPU backend flushes
float32 denormals, so the port's runs here do too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import scenes
from _torch_scenes import LIT_ROOM_CAMERA, lit_room

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu import render as jax_render
from srt_tpu.diff import image_loss as jax_image_loss
from srt_tpu.render.api import render_tonemapped as jax_render_tonemapped
from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu_torch import RenderConfig, convert, make_train_step, render
from srt_tpu_torch import render_regen
from srt_tpu_torch.diff.inverse import image_loss
from srt_tpu_torch.render import film
from srt_tpu_torch.render.api import render_tonemapped
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)

CFG = dict(width=16, height=16, spp=2, max_depth=4, sample_chunk=2,
           pixel_chunk=128)
#: pixels beyond 1e-2 against JAX's jitted engine (C5 on ball_scenes)
FRAC_BAD = {"ball_scenes": 0.35, "cornell_boxes": 0.15}


@pytest.fixture(scope="module", autouse=True)
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _jax(fn, *args, op_by_op=False, **kw):
    """A JAX call with its warnings silenced, jitted or op by op."""
    eager = jax.disable_jit() if op_by_op else contextlib.nullcontext()
    with eager, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


@pytest.fixture(scope="module")
def port_renders():
    """The port's scan image and metrics of each scene, and its regen
    image."""
    out = {}
    for name in FRAC_BAD:
        _, _, scene, cam = scenes(name)
        img, m = render(scene, cam, RenderConfig(**CFG), metrics=True)
        out[name] = (img.numpy(), m,
                     render_regen(scene, cam, RenderConfig(**CFG)).numpy())
    return out


@pytest.mark.parametrize("name", sorted(FRAC_BAD))
def test_render_matches_jax(name, port_renders):
    scene_j, cam_j, _, _ = scenes(name)
    img_j, m_j = _jax(jax_render, scene_j, cam_j, JaxRenderConfig(**CFG),
                      metrics=True)
    img, m, _ = port_renders[name]
    assert img.shape == (16, 16, 3)
    contract.check_image(img, np.asarray(img_j), frac_bad=FRAC_BAD[name])
    assert m.nan_scrubbed == m_j.nan_scrubbed == 0
    assert m.primary_rays == m_j.primary_rays == 512
    assert m.bounce == "B2"
    assert m.walk == ("B3" if name == "cornell_boxes" else None)
    # two pixel chunks × one sample chunk, four bounces each
    assert m.bounces == 2 * 4


@pytest.mark.parametrize("name", sorted(FRAC_BAD))
def test_alive_per_bounce_matches_jax(name, port_renders):
    scene_j, cam_j, _, _ = scenes(name)
    _, m_j = _jax(jax_render, scene_j, cam_j, JaxRenderConfig(**CFG),
                  metrics=True, op_by_op=True)
    _, m, _ = port_renders[name]
    lanes = m.primary_rays
    hist, hist_j = m.alive_per_bounce, np.asarray(m_j.alive_per_bounce)
    assert hist.shape == hist_j.shape == (4,) and hist[0] == lanes
    assert (np.abs(hist - hist_j) <= contract.ALIVE_MISMATCH * lanes).all(), \
        (hist, hist_j)
    assert m.path_vertices == hist.sum()


def test_render_tonemapped_matches_jax(port_renders):
    scene_j, cam_j, scene, cam = scenes("cornell_boxes")
    tm_j = np.asarray(_jax(jax_render_tonemapped, scene_j, cam_j,
                           JaxRenderConfig(**CFG)))
    tm = render_tonemapped(scene, cam, RenderConfig(**CFG)).numpy()
    assert tm.min() >= 0.0 and tm.max() <= 1.0
    contract.check_image(tm, tm_j)
    np.testing.assert_array_equal(tm, film.tonemap(torch.from_numpy(
        port_renders["cornell_boxes"][0])).numpy())


@pytest.mark.parametrize("name", sorted(FRAC_BAD))
def test_scan_matches_regen(name, port_renders):
    """Both engines draw every decision from the same streams, so the scan
    image is the regeneration image up to the order of the sums."""
    img, _, img_regen = port_renders[name]
    contract.check_image(img, img_regen)


def test_seq_stale_matches_jax_and_the_parity_scan():
    scene_j, cam_j, scene, cam = scenes("cornell_boxes")
    cfg = dict(CFG, ref_parity=True, seq_stale=True)
    img_j = np.asarray(_jax(jax_render, scene_j, cam_j,
                            JaxRenderConfig(**cfg)))
    seq = render(scene, cam, RenderConfig(**cfg))
    contract.check_image(seq.numpy(), img_j)
    parity = render(scene, cam, RenderConfig(**dict(
        cfg, seq_stale=False, sample_chunk=1)))
    assert torch.equal(seq, parity)
    # seq_stale without parity is the default render
    plain = dataclasses.replace(RenderConfig(**cfg), ref_parity=False)
    assert torch.equal(render(scene, cam, plain),
                       render(scene, cam, RenderConfig(**CFG)))


LOSS = dict(width=8, height=8, spp=2, max_depth=4)


def _lit_room():
    scene_j = lit_room(JaxSceneBuilder()).build()
    cam_j = JaxCamera.look_at(**LIT_ROOM_CAMERA)
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    return scene_j, cam_j, scene, cam


def test_scan_train_step_loss_matches_jax():
    """``make_train_step(engine="scan")``'s first loss on lit_room
    (``{tex_color}``, a constant 0.3 target) against JAX's scan loss
    within 1e-4 relative, the bound of ``test_torch_train.py``."""
    scene_j, cam_j, scene, cam = _lit_room()
    n = LOSS["width"] * LOSS["height"]
    target = np.full((n, 3), 0.3, np.float32)
    loss_j = float(_jax(jax_image_loss, {"tex_color": scene_j.tex_color},
                        scene_j, cam_j, target,
                        jnp.arange(n, dtype=jnp.int32), seed=7,
                        engine="scan", **LOSS))
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           engine="scan", device="cpu", **LOSS)
    before = step.params["tex_color"].detach().clone()
    loss = float(step(target, 7))
    assert abs(loss - loss_j) <= 1e-4 * loss_j, (loss, loss_j)
    assert not torch.equal(step.params["tex_color"], before)


def test_scan_gradient_matches_finite_differences():
    """The scan engine's ``tex_color`` gradient against central
    differences of its own loss with common random numbers, on the two
    most influential rows: within 3e-3 plus 5% of the quotient, the bound
    of ``test_torch_train.py`` (JAX's scan gradient detaches the BSDF
    sample, ROADMAP C12, so the port is held to its own loss)."""
    _, _, scene, cam = _lit_room()
    pix = torch.arange(LOSS["width"] * LOSS["height"])
    target = torch.full((pix.shape[0], 3), 0.3)

    def loss(tc):
        return image_loss({"tex_color": tc}, scene, cam, target, pix, seed=7,
                          engine="scan", **LOSS)

    tc = scene.tex_color.clone().requires_grad_()
    loss(tc).backward()
    g = tc.grad.numpy()
    assert np.isfinite(g).all()
    for i in np.argsort(np.abs(g).sum(1))[-2:]:
        for c in range(3):
            delta = torch.zeros_like(tc)
            delta[i, c] = 3e-3
            with torch.no_grad():
                q = (float(loss(scene.tex_color + delta))
                     - float(loss(scene.tex_color - delta))) / 6e-3
            assert abs(q - g[i, c]) < 3e-3 + 0.05 * abs(q), (i, c, q, g[i, c])
