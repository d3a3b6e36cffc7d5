"""srt_tpu_torch.core against srt_tpu.core: RNG words bit for bit, the
special-function fits to a few ulp, Sobol points exactly."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.core import approx as japprox
from srt_tpu.core import rng as jrng
from srt_tpu.core.sobol import sobol_points as jsobol
from srt_tpu_torch.core import approx, rng
from srt_tpu_torch.core.sobol import sobol_points

torch.set_num_threads(1)


def _words(n: int, seed: int) -> np.ndarray:
    w = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
    w[:4] = [0, 1, (1 << 31) - 1, 0xFFFFFFFF]
    w[4:8] = [1 << 31, (1 << 31) + 1, 0x9E3779B9, 0xB5297A4D]
    return w.astype(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.astype(np.int64))


def test_rng_words_bit_exact():
    a, b = _words(20000, 0), _words(20000, 1)
    assert (a >= 1 << 31).mean() > 0.4          # the sign bit is exercised
    np.testing.assert_array_equal(
        rng.hash_combine(_t(a), _t(b)).numpy(),
        np.asarray(jrng.hash_combine(a, b)).astype(np.int64))
    sampler = jrng.RaySampler(salt=jnp.asarray(a))
    for dim in (0, 12, 13, 14, 15, 16, 32, 33, 34, 63):
        np.testing.assert_array_equal(
            rng.bits(_t(a), dim).numpy(),
            np.asarray(sampler.bits(dim)).astype(np.int64))
        np.testing.assert_array_equal(rng.uniform(_t(a), dim).numpy(),
                                      np.asarray(sampler.uniform(dim)))


def test_rng_salts_match_ray_sampler():
    r = np.random.default_rng(2)
    pix = r.integers(0, 1 << 20, 5000).astype(np.int32)
    samp = r.integers(0, 1 << 10, 5000).astype(np.int32)
    for seed in (0, 7, (1 << 32) - 1):
        want = jrng.RaySampler.create(seed, pix, samp)
        got = rng.create_salt(seed, torch.from_numpy(pix),
                              torch.from_numpy(samp))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(want.salt).astype(np.int64))
        depth = r.integers(0, 50, 5000).astype(np.int32)
        np.testing.assert_array_equal(
            rng.hash_combine(got, rng.as_word(torch.from_numpy(depth)))
            .numpy(), np.asarray(want.fold(depth).salt).astype(np.int64))


@pytest.mark.parametrize("name,lo,hi,scale,ulps", [
    # erf_as returns 1 - poly*exp: its rounding is that of values near 1
    ("erf_as", -3.0, 3.0, 1.0, 4),
    ("erfinv_giles", -1.0, 1.0, 0.0, 4),
    ("acos_as", -1.0, 1.0, 0.0, 4),
])
def test_approx_within_ulps(name, lo, hi, scale, ulps):
    # Both sides op by op (the JAX functions called outside jit); the fits
    # differ only where libm's exp/log/sqrt round differently.
    x = np.random.default_rng(3).uniform(lo, hi, 50000).astype(np.float32)
    x[:3] = [lo, 0.0, hi]
    got = getattr(approx, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(japprox, name)(jnp.asarray(x)))
    spacing = np.spacing(np.maximum(np.abs(want), np.float32(scale)))
    assert (np.abs(got - want) <= ulps * spacing).all(), \
        np.max(np.abs(got - want) / spacing)


@pytest.mark.parametrize("n,d", [(1, 2), (16, 2), (64, 2), (100, 7),
                                 (256, 32)])
def test_sobol_points_equal(n, d):
    np.testing.assert_array_equal(sobol_points(n, d), jsobol(n, d))


@pytest.mark.parametrize("seed", [0, 5])
def test_rng_pixel_jitter_equal(seed):
    """``RenderConfig(sobol_pixel_jitter=False)``: the sampler-stream jitter."""
    from srt_tpu.render.api import _rng_jitter as jax_rng_jitter
    from srt_tpu_torch.render.api import _rng_jitter
    np.testing.assert_array_equal(_rng_jitter(16, seed).numpy(),
                                  np.asarray(jax_rng_jitter(16, seed)))
