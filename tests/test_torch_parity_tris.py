"""The parity estimator on cornell_boxes, the triangle path: the port's
plain parity bounce, fed its plain triangle walk's hit, against JAX's
(``tests/_torch_parity.py:check_parity_bounces``: three bounces against
the jitted XLA bounce, one against JAX's parity kernel in interpret mode,
under the per-bounce contract with the ``stale`` plane's), and the
parity image against JAX's ``render_regen`` under the default image
bounds.

cornell_boxes has no Beckmann lane, so its parity bounce exercises the
light-only draw of its Lambertian walls and boxes and the external hit,
not the heap slot (``test_torch_parity_bounce.py`` does). Its light is its
one NEE light, so parity divides each light sample by the 50/50 mixture
pdf, doubling the direct light, and loses the indirect: the linear mean
comes out a few percent brighter than the default one in both packages
(0.1619 against 0.1579 at 48x48, 16 spp, depth 50 on the CPU; the
tonemapped image is darker, its shadows unlit), and the port's
parity/default ratio must equal JAX's.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from _torch_parity import (camera_state, check_parity_bounces, images,
                           parity_flags, plain_hit, scenes, to_torch)

from srt_tpu_torch.utils import contract

torch.set_num_threads(1)


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_parity_bounce_on_triangles_matches_xla(flush_denormals):
    scene_j, cam_j, scene, _ = scenes("cornell_boxes")
    _, flags = parity_flags(scene_j, scene)
    st = to_torch(camera_state(cam_j, 4096))
    tri = plain_hit(scene, st, flags)
    assert int((tri[0] < 3e38).sum()) > 500     # boxes in view
    total, kernel = check_parity_bounces("cornell_boxes", no_stale=False)
    assert total["drew"] > 2000 and kernel["drew"] > 100, (total, kernel)
    assert total["stores"] == total["slot_reads_0"] == 0, total


def test_parity_image_on_triangles_matches_jax(flush_denormals, monkeypatch):
    """32x32, 4 spp, depth 8: the parity image under the default image
    bounds, and the parity/default ratio of the means equal to JAX's
    within 2%."""
    monkeypatch.delenv("SRT_TPU_PALLAS", raising=False)
    scene_j, cam_j, scene, cam = scenes("cornell_boxes")
    cfg = dict(width=32, height=32, spp=4, max_depth=8)
    par_j, par = images(scene_j, cam_j, scene, cam, True, **cfg)
    contract.check_image(par, par_j)
    std_j, std = images(scene_j, cam_j, scene, cam, False, **cfg)
    ratio, ratio_j = par.mean() / std.mean(), par_j.mean() / std_j.mean()
    np.testing.assert_allclose(ratio, ratio_j, rtol=0.02)
