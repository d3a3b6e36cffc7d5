"""The roofline arithmetic against hand counts on a tiny scene."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark import work


def tiny(moving: bool = False, mats=(2, 5)) -> dict:
    c0 = np.zeros((3, 3), np.float32)
    c1 = c0 + (np.float32(0.5) if moving else np.float32(0.0))
    return dict(sph_center0=c0, sph_center1=c1,
                sph_radius=np.ones(3, np.float32),
                rect_k=np.zeros(2, np.float32),
                mat_type=np.asarray(mats, np.int32))


def test_sweep_and_shade_counts():
    assert work.sweep_ops(tiny()) == 3 * 21 + 2 * 10
    assert work.sweep_ops(tiny(moving=True)) == 3 * 28 + 2 * 10
    assert work.shade_ops(tiny(mats=(1, 5))) == 600
    assert work.shade_ops(tiny(mats=(0, 3, 4, 5))) == 120
    assert work.shade_ops(tiny(mats=(5,))) == 0


def test_b1_hand_count():
    # 10 launches of 100 lanes, 400 vertices from 250 rays
    t, by = work.b1(tiny(), launches=10, lanes=100, vertices=400, rays=250)
    n_bytes = 10 * 100 * 80 + 400 * 48 + 250 * 12
    ops = 400 * 83 + 150 * 600
    assert by == "bytes"
    assert t == pytest.approx(n_bytes / 3.35e12)
    assert ops / 67e12 < t
    # one launch of 8 lanes on a 400-sphere scene: the sweep sets it
    big = dict(tiny(), sph_center0=np.zeros((400, 3), np.float32),
               sph_center1=np.zeros((400, 3), np.float32),
               sph_radius=np.ones(400, np.float32))
    t, by = work.b1(big, launches=1, lanes=8, vertices=8, rays=8)
    assert by == "operations"
    assert t == pytest.approx(8 * (400 * 21 + 20) / 67e12)


def test_film_b2_b5_hand_counts():
    t, by = work.film(launches=4, lanes=64, rays=100, pixels=25)
    assert by == "bytes"
    assert t == pytest.approx((4 * (64 * 8 + 16) + 100 * 16 + 25 * 24)
                              / 3.35e12)
    t, _ = work.b2(tiny(moving=True), vertices=300, rays=100)
    assert t == pytest.approx(max(300 * 110 / 3.35e12,
                                  (300 * 104 + 200 * 600) / 67e12))
    t, _ = work.b5(tiny(), vertices=300, rays=100)
    assert t == pytest.approx(max(300 * 197 / 3.35e12,
                                  (300 * 83 + 200 * 3 * 600) / 67e12))
