"""The benchmark's frozen scene generators give the arrays of the scenes
users render: the port's library on the CPU, field for field and bit for
bit (the sphere BVH, which the port's builder adds and the cells never
walk, left out), and the same camera."""
from __future__ import annotations

import warnings

import numpy as np
import pytest

from benchmark.scenes import ball_scenes, random_scene
from srt_tpu_torch import get_scene


@pytest.mark.parametrize("name,make", [("ball_scenes", ball_scenes.make),
                                       ("random_scene", random_scene.make)])
def test_generator_equals_library(name, make):
    arrays, cam = make()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, camera, _ = get_scene(name, device="cpu")
    for k, v in arrays.items():
        w = getattr(scene, k)
        if v is None:
            assert w is None, k
            continue
        w = w.numpy()
        assert v.dtype == w.dtype and v.shape == w.shape, k
        assert np.array_equal(v, w), k
    for k in camera._fields:
        assert np.array_equal(cam[k], getattr(camera, k).numpy()), k
