"""The port's regeneration engine against the JAX package's, end to end.

Image contract as in tests/test_fused_bounce.py:180-183, with one bound
loosened and why: JAX's engine runs jitted, and inside jitted code XLA's
CPU backend contracts multiply-adds into fused multiply-adds while
PyTorch's eager operations round every product. On the near-mirror
Beckmann spheres those last-bit differences resample a path wherever it
sits on a knife edge, so at this size about 28% of pixels differ by more
than 1e-2 on the CPU where the JAX kernel-against-XLA comparison stays
under 15%. The op-by-op comparison in tests/test_torch_bounce.py shows the
estimator itself agrees; here the mean, the median pixel and the traced
path vertices must still agree.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu.render.regen import render_regen as jax_render_regen
from srt_tpu.scene.library import ball_scenes
from srt_tpu_torch import RenderConfig, convert, render_regen
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)


@pytest.fixture
def flush_denormals():
    # XLA's CPU backend flushes float32 denormals; do the same here
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_ball_scenes_image_matches_jax(flush_denormals, monkeypatch):
    monkeypatch.delenv("SRT_TPU_PALLAS", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene_j, cam_j, _ = ball_scenes(aspect=1.0)
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    cfg = dict(width=32, height=32, spp=4, max_depth=6)
    img_j, m_j = jax_render_regen(scene_j, cam_j, JaxRenderConfig(**cfg),
                                  metrics=True)
    img, m = render_regen(scene, cam, RenderConfig(**cfg), metrics=True)
    assert img.shape == (32, 32, 3) and img.dtype == torch.float32
    contract.check_image(img.numpy(), np.asarray(img_j), frac_bad=0.35)
    assert m.nan_scrubbed == m_j.nan_scrubbed == 0
    # traced vertices within 1.5% (0.7% here on the CPU): diverged paths
    assert abs(m.path_vertices - m_j.path_vertices) < 0.015 * m_j.path_vertices
    assert m.primary_rays == m_j.primary_rays == 32 * 32 * 4
