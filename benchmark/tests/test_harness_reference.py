"""The plain reference against the port's plain versions on the CPU at a
few pixels: the regeneration and scan engines' images, and the scan
train step's losses, first gradient and parameters after three steps;
and the reference's own images of the sphere scenes, pinned. (The test
imports both; the reference imports nothing of the port.)"""
from __future__ import annotations

import functools
import hashlib
import warnings

import numpy as np
import pytest
import torch

from benchmark.reference import path
from benchmark.reference.camera import camera_from
from benchmark.reference.scene import Scene
from benchmark.scenes import ball_scenes, random_scene
from benchmark.tests._library import library_arrays
from srt_tpu_torch import RenderConfig, convert, make_train_step, render
from srt_tpu_torch import render_regen

W = H = 8
SEED = 3_000_000_019


def port_scene(arrays, cam):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (convert.scene_from_arrays(arrays, device="cpu"),
                convert.camera_from_arrays(cam, device="cpu"))


#: the sphere scenes from the benchmark's generators; the triangle scenes
#: from the port's library, BVH order and all, which the port needs until
#: it derives its tables from a soup: cornell_boxes' 24 triangles, and
#: the teapot's 1,984 metal and Beckmann ones with the glass sphere and
#: its medium
SCENES = {"ball_scenes": ball_scenes.make, "random_scene": random_scene.make,
          "cornell_boxes": functools.partial(library_arrays,
                                             "cornell_boxes"),
          "teapot_scene": functools.partial(library_arrays, "teapot_scene",
                                            divs=4)}


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("engine", ["regen", "scan"])
def test_render_matches_the_port(scene, engine):
    arrays, cam = SCENES[scene]()
    ps, pc = port_scene(arrays, cam)
    cfg = RenderConfig(width=W, height=H, spp=4, max_depth=50, seed=SEED,
                       wavefront=128, sample_chunk=2, pixel_chunk=32)
    fn = render_regen if engine == "regen" else render
    img = fn(ps, pc, cfg).numpy().reshape(-1, 3)
    ref, live = path.render_pixels(Scene(arrays, "cpu"), camera_from(cam, "cpu"),
                                   torch.arange(W * H), width=W, height=H,
                                   spp=4, max_depth=50, seed=SEED)
    # the same paths; only the order of a pixel's sums differs
    np.testing.assert_allclose(img, ref.numpy(), rtol=0, atol=2e-7)
    assert live[0] == W * H * 4 and live == sorted(live, reverse=True)


#: sha256 of the reference's 8x8 image at 4 spp, depth 50, before the
#: triangle family and media joined it: the sphere path kept bit for bit
DIGESTS = {
    "ball_scenes":
        "7d4e3c55f795a414807fbad70d02d6baaa4ca3535576332895ef6e2fa4cf093b",
    "random_scene":
        "775031331b476466d6f8bf68d5babc69ad0ff81ca5b11e69c7f51d805fef9d56"}


@pytest.mark.parametrize("scene", list(DIGESTS))
def test_sphere_scene_images_are_pinned(scene):
    arrays, cam = SCENES[scene]()
    img, _ = path.render_pixels(Scene(arrays, "cpu"), camera_from(cam, "cpu"),
                                torch.arange(W * H), width=W, height=H,
                                spp=4, max_depth=50, seed=SEED)
    assert hashlib.sha256(img.numpy().tobytes()).hexdigest() \
        == DIGESTS[scene]


def test_pixel_subset_is_the_image_at_those_pixels():
    arrays, cam = ball_scenes.make()
    rs, rc = Scene(arrays, "cpu"), camera_from(cam, "cpu")
    kw = dict(width=W, height=H, spp=2, max_depth=50, seed=SEED)
    full, _ = path.render_pixels(rs, rc, torch.arange(W * H), **kw)
    ids = torch.tensor([3, 17, 40, 63])
    part, _ = path.render_pixels(rs, rc, ids, block_lanes=4, **kw)
    torch.testing.assert_close(part, full[ids], rtol=0, atol=0)


def test_train_steps_match_the_port():
    arrays, cam = ball_scenes.make()
    ps, pc = port_scene(arrays, cam)
    seeds = [SEED, SEED + 1, SEED + 2]
    target = torch.full((H, W, 3), 0.3)
    step = make_train_step(ps, pc, {"tex_color": ps.tex_color}, width=W,
                           height=H, spp=2, max_depth=50, lr=1e-2,
                           engine="scan", device="cpu")
    param = step.params["tex_color"]
    losses = []
    for k, s in enumerate(seeds):
        losses.append(float(step(target, s)))
        if k == 0:
            g1 = step.optimizer.state[param]["exp_avg"] / 0.1
    ref = path.adam_steps(Scene(arrays, "cpu"), camera_from(cam, "cpu"),
                          torch.from_numpy(arrays["tex_color"]),
                          target.reshape(-1, 3), seeds, lr=1e-2, width=W,
                          height=H, spp=2, max_depth=50)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6)
    torch.testing.assert_close(g1, ref["grad1"], rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(param.detach(), ref["params"], rtol=1e-6,
                               atol=1e-7)


def test_bfloat16_planes_change_the_image():
    arrays, cam = ball_scenes.make()
    rs, rc = Scene(arrays, "cpu"), camera_from(cam, "cpu")
    kw = dict(width=W, height=H, spp=2, max_depth=50, seed=SEED)
    f32, _ = path.render_pixels(rs, rc, torch.arange(W * H), **kw)
    b16, _ = path.render_pixels(rs, rc, torch.arange(W * H),
                                planes=torch.bfloat16, **kw)
    assert float((f32 - b16).abs().median()) > 1e-5
