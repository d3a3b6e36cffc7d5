"""The port's plain parity bounce (kernel B2's plain version under
``ref_parity``) against the JAX package's on ball_scenes, lane by lane
(``tests/_torch_parity.py:check_parity_bounces``; the same with
``parity_no_stale`` in ``test_torch_parity_no_stale.py``).

Inputs: camera rays from JAX's sampler, three bounces along JAX's
trajectory, then one bounce against JAX's parity kernel in interpret
mode. Tolerances: the per-bounce contract of ``srt_tpu_torch.utils.
contract`` (the JAX package's kernel-against-XLA bounds) with the
``stale`` plane's, 1e-3 on at most 5% of the live lanes (JAX's own parity
test, ``tests/test_fused_bounce.py:324-340``). The XLA reference runs
jitted, so its multiply-adds are contracted (ROADMAP C5), which the
contract's shares absorb. The states must reach every mechanism of the
parity draw: retries, Beckmann light-branch reads of the heap slot that
see 0 and 1e30, and BSDF draws that store their pdf in it; a test on a
state with no retries would guard nothing.
"""
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


def test_parity_bounce_matches_xla(flush_denormals):
    total, kernel = check_parity_bounces("ball_scenes", no_stale=False)
    assert total["retried"] > 50 and total["stores"] > 100, total
    assert total["slot_reads_0"] > 20, total
    assert total["slot_reads_1e30"] > 100, total
    assert kernel["retried"] and kernel["stores"], kernel
    assert kernel["slot_reads_0"] and kernel["slot_reads_1e30"], kernel
