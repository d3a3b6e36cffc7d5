"""The plain reference against the port's plain versions on the CPU at a
few pixels: the regeneration and scan engines' images, and the scan
train step's losses, first gradient and parameters after three steps.
(The test imports both; the reference imports nothing of the port.)"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from benchmark.reference import path
from benchmark.reference.camera import camera_from
from benchmark.reference.scene import Scene
from benchmark.scenes import ball_scenes, random_scene
from srt_tpu_torch import RenderConfig, convert, make_train_step, render
from srt_tpu_torch import render_regen

W = H = 8
SEED = 3_000_000_019


def port_scene(arrays, cam):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (convert.scene_from_arrays(arrays, device="cpu"),
                convert.camera_from_arrays(cam, device="cpu"))


@pytest.mark.parametrize("make", [ball_scenes.make, random_scene.make],
                         ids=["ball_scenes", "random_scene"])
@pytest.mark.parametrize("engine", ["regen", "scan"])
def test_render_matches_the_port(make, engine):
    arrays, cam = make()
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
