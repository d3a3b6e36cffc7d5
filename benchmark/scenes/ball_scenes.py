"""``ball_scenes``, the reference renderer's default scene (sceneid 2,
``Raytracing_n.cpp:379-425``): an 11x11 sweep of anisotropic Beckmann
roughness spheres on an Oren–Nayar floor, lit by a rect light and an
image-textured environment dome.

A frozen copy of ``srt_tpu_torch/scene/library.py:107-134``. The dome's
image, ``environment_map/sky_2.png``, is not in the repository, so the
dome shows the library's 8x8 stand-in, as every render of the port does
without assets. Nothing here is seeded.
"""
from __future__ import annotations

from benchmark.reference.camera import Camera, camera_arrays
from benchmark.scenes.builder import SceneArrays, stand_in


def make(aspect: float = 1.0) -> tuple[dict, dict]:
    """The scene's arrays and its camera's."""
    lookfrom = (300.0, 600.0, -100.0)
    b = SceneArrays()

    light = b.diffuse_light(b.constant((20.0, 20.0, 20.0)))
    on_brown = b.oren_nayar(b.constant((0.426, 0.3, 0.254)), 0.0)

    lid = b.xz_rect(203, 353, 217, 343, 800, light, flip=True)   # :396
    b.xz_rect(-100, 655, -100, 655, 0, on_brown)                 # :397
    # the dome (library.py:98-104), sky_2.png's stand-in
    b.sphere(lookfrom, 10000.0, b.diffuse_light(
        b.image(stand_in((0.6, 0.7, 0.9)))), flip=True)

    white = b.constant((1.0, 1.0, 1.0))
    for j in range(121):                                          # :404-411
        mat = b.beckmann(white, (j % 11) / 11.0, (j // 11) / 11.0)
        b.sphere((550.0 - (j % 11) * 50.0, 20.0, 450.0 - 50.0 * (j // 11)),
                 20.0, mat)
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 20, 250), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    return b.build(), camera_arrays(cam)
