"""Parity on ``tests/test_render.py:274-300``'s lit floor, the port's
``render_regen`` against the JAX package's (its XLA bounce on the CPU):
parity lights the Oren–Nayar floor only through the weak NEE light, not
the bright dome, so the floor is darker than half the default one, and
the port's parity/default ratio must equal JAX's within 2%.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from _torch_parity import LIT_FLOOR_CAMERA, images, lit_floor

from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu_torch import convert

torch.set_num_threads(1)


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_parity_darkens_the_lit_floor_as_jax(flush_denormals, monkeypatch):
    monkeypatch.delenv("SRT_TPU_PALLAS", raising=False)
    scene_j = lit_floor(JaxSceneBuilder()).build()
    cam_j = JaxCamera.look_at(**LIT_FLOOR_CAMERA)
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    cfg = dict(width=24, height=24, spp=32, max_depth=5)
    par_j, par = images(scene_j, cam_j, scene, cam, True, **cfg)
    std_j, std = images(scene_j, cam_j, scene, cam, False, **cfg)
    assert np.isfinite(par).all() and np.isfinite(std).all()
    floor, floor_j = par[16:].mean() / std[16:].mean(), \
        par_j[16:].mean() / std_j[16:].mean()
    assert floor < 0.5, floor
    np.testing.assert_allclose(floor, floor_j, rtol=0.02)
