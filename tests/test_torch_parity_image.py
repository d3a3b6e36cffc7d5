"""Parity images, the port's ``render_regen`` against the JAX package's
(its XLA bounce on the CPU).

* ball_scenes at 32x32, 4 spp, depth 5 against JAX's engine run op by
  op, under the image contract's default bounds, tighter than JAX's own
  parity test (|Δmean| < 3% relative, 80% of pixels within rtol 1e-4).
  Against the jitted engine the means part by 0.0113 (6.9%): XLA
  contracts multiply-adds (ROADMAP C5), a few paths on the near-mirror
  Beckmann spheres diverge, and parity's heavy tails (a light sample
  divided by half a small light pdf where the heap slot reads 0) make
  them fireflies; JAX's jitted image differs from its own op-by-op one
  by the same 0.0113, where the port's differs by 1.5e-8 (ROADMAP C15).

The lit floor is in ``test_torch_parity_floor.py``.
"""
from __future__ import annotations

import pytest
import torch
from _torch_parity import images, scenes

from srt_tpu_torch.utils import contract

torch.set_num_threads(1)


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_parity_image_matches_jax(flush_denormals, monkeypatch):
    monkeypatch.delenv("SRT_TPU_PALLAS", raising=False)
    scene_j, cam_j, scene, cam = scenes("ball_scenes")
    img_j, img = images(scene_j, cam_j, scene, cam, True, op_by_op=True,
                        width=32, height=32, spp=4, max_depth=5)
    contract.check_image(img, img_j)
