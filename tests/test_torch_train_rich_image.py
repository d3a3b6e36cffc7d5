"""The train step's bounce gradient against the JAX package on the rich
scenes with image albedo: ``earth_sphere`` (an image-emissive sphere
light) and the media room (``tests/_torch_scenes.py:lit_room_media``:
sphere and box media, metal, glass and image-albedo spheres), by the
check of ``tests/test_torch_train_rich.py``, which holds the other two
scenes; the four are split over two files so that JAX's interpret-mode
backward kernel runs on two workers.
"""
from __future__ import annotations

import pytest
import torch
from test_torch_train_rich import check_rich_backward

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:asset .* missing")


@pytest.fixture
def flush_denormals():
    # XLA's CPU backend flushes float32 denormals; do the same here
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("name", ["earth_sphere", "lit_room_media"])
def test_rich_bounce_backward_matches_jax_kernel(name, flush_denormals,
                                                 monkeypatch):
    monkeypatch.delenv("SRT_TPU_BWD_KERNEL", raising=False)
    check_rich_backward(name)
