"""``parity_no_stale``, the parity estimator whose heap slot reads 0, on
ball_scenes: the port's plain bounce against JAX's as in
``test_torch_parity_bounce.py`` (same inputs, same tolerances)."""
from __future__ import annotations

import pytest
import torch
from _torch_parity import check_parity_bounces

torch.set_num_threads(1)


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_parity_no_stale_bounce_matches_xla(flush_denormals):
    total, kernel = check_parity_bounces("ball_scenes", no_stale=True)
    assert total["retried"] > 50 and total["stores"] > 100, total
    assert total["slot_reads_0"] > 100, total
    assert total["slot_reads_1e30"] == 0, total
    assert kernel["retried"] and kernel["slot_reads_0"], kernel
