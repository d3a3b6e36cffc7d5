"""``random_scene``, the cover of *Ray Tracing in One Weekend* as the
reference renderer builds it (``Raytracing_n.cpp:108-176``): a checker
ground, a 22x22 grid of drifting Lambertian, metal and glass spheres drawn
from a seeded generator, three hero spheres, inside a cube of six inward
image-textured rect lights.

A frozen copy of ``srt_tpu_torch/scene/library.py:288-352``. The cube's
``environment_map/sky_1/*.jpg`` images are not in the repository, so each
face shows the library's 8x8 stand-in.
"""
from __future__ import annotations

import numpy as np

from benchmark.reference.camera import Camera, camera_arrays
from benchmark.scenes.builder import SceneArrays, stand_in


def make(aspect: float = 1.0, n_grid: int = 11,
         seed: int = 7) -> tuple[dict, dict]:
    """The scene's arrays and its camera's; ``seed`` draws the grid."""
    b = SceneArrays()
    rng = np.random.default_rng(seed)

    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))

    gray = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    glass = b.dielectric(1.5)
    for a in range(-n_grid, n_grid):
        for c in range(-n_grid, n_grid):
            choose = rng.uniform()
            center = np.array([a + 0.9 * rng.uniform(), 0.2,
                               c + 0.9 * rng.uniform()], np.float32)
            if np.linalg.norm(center - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if choose < 0.8:  # a drifting grey Lambertian (moving_sphere)
                b.sphere(center, 0.2, gray,
                         center1=center + np.array([0, 0.5 * rng.uniform(),
                                                    0], np.float32))
            elif choose < 0.95:
                metal = b.metal((0.5 * (1 + rng.uniform()),
                                 0.5 * (1 + rng.uniform()),
                                 0.5 * (1 + rng.uniform())),
                                0.5 * rng.uniform())
                b.sphere(center, 0.2, metal)
            else:
                b.sphere(center, 0.2, glass)

    b.sphere((0, 1, 0), 1.0, glass)
    b.sphere((-4, 1, 0), 1.0, b.lambertian(b.constant((0.4, 0.2, 0.1))))
    b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))

    # the cube environment, every face emitting inward (library.py:333-345)
    def face(add):
        tex = b.image(stand_in((0.6, 0.7, 0.9)))
        b.light_rect(add(b.diffuse_light(tex)))

    e = 100.0
    face(lambda m: b.xy_rect(-e, e, -e, e, -e, m))              # Front
    face(lambda m: b.xy_rect(-e, e, -e, e, e, m, flip=True))    # Back
    face(lambda m: b.yz_rect(-e, e, -e, e, e, m, flip=True))    # Left
    face(lambda m: b.yz_rect(-e, e, -e, e, -e, m))              # Right
    face(lambda m: b.xz_rect(-e, e, -e, e, e, m, flip=True))    # Top
    face(lambda m: b.xz_rect(-e, e, -e, e, -e, m))              # Bottom

    cam = Camera.look_at((-10.0, 6.0, -15.0), (0.0, 0.0, 0.0), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    return b.build(), camera_arrays(cam)
