"""Scenes inside srt_tpu_torch's coverage, built the same way by either
package's SceneBuilder. ``lit_room``: two rect lights (one
image-textured), no environment dome (so rays miss), a flipped-normal
sphere, Beckmann spheres from near-mirror to rough, an Oren–Nayar floor.
``lit_room_media``: the same room with a sphere medium and a box medium,
a metal and a glass sphere, and an image-textured Lambertian sphere."""
from __future__ import annotations

import numpy as np

LIT_ROOM_CAMERA = dict(lookfrom=(0.0, 4.0, 12.0), lookat=(0.0, 1.0, 0.0),
                       vfov=50.0, aspect=1.0, aperture=0.0, focus_dist=10.0)


def lit_room(b):
    """Fill builder ``b`` (``srt_tpu`` or ``srt_tpu_torch``) and return it."""
    warm = b.diffuse_light(b.constant((4.0, 3.0, 2.0)))
    texels = (np.arange(4 * 6 * 3).reshape(4, 6, 3) * 3).astype(np.uint8)
    panel = b.diffuse_light(b.image(texels))
    floor = b.oren_nayar(b.constant((0.5, 0.5, 0.5)), 20.0)
    top = b.xz_rect(-2, 2, -2, 2, 5, warm, flip=True)
    side = b.yz_rect(0, 3, -2, 2, -4, panel)
    b.xz_rect(-10, 10, -10, 10, 0, floor)
    for i in range(5):
        b.sphere((2.0 * i - 4.0, 1.0, 0.0), 1.0,
                 b.beckmann(b.constant((0.9, 0.6, 0.3)), 0.1 * i, 0.3))
    b.sphere((0.0, 3.0, -2.0), 0.5, floor, flip=True)
    b.light_rect(top)
    b.light_rect(side)
    return b


def lit_room_media(b):
    """``lit_room`` plus a sphere medium, a box medium, a metal and a
    glass sphere and an image-albedo sphere; returns the builder."""
    lit_room(b)
    b.medium_sphere((1.0, 1.5, 2.0), 1.2, 0.6, b.constant((0.8, 0.5, 0.3)))
    b.medium_box((-3.5, 0.0, 1.0), (-1.5, 2.5, 3.0), 0.4,
                 b.constant((0.3, 0.6, 0.9)))
    b.sphere((3.0, 0.6, 2.5), 0.6, b.metal((0.9, 0.8, 0.7), 0.2))
    b.sphere((-1.0, 0.6, 3.5), 0.6, b.dielectric(1.5))
    texels = (np.arange(5 * 7 * 3).reshape(5, 7, 3) * 2 + 30).astype(np.uint8)
    b.sphere((1.0, 3.5, -1.0), 0.7, b.lambertian(b.image(texels)))
    return b


def clustered_soup(builder_cls, n_rays: int):
    """1,500 seeded triangles in a ``builder_cls`` builder clustered at caps
    128/256 (dozens of clusters under a deep top tree), and ``n_rays``
    seeded unit rays through them: ``(builder, o, d)``, the rays float32
    numpy arrays."""
    r = np.random.default_rng(8)
    b = builder_cls(cluster_node_cap=128, cluster_tri_cap=256)
    b.triangles(r.standard_normal((1500, 3, 3)).astype(np.float32),
                b.lambertian(b.constant((0.5, 0.5, 0.5))))
    o = (r.standard_normal((n_rays, 3)) * 3).astype(np.float32)
    d = r.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return b, o, d
