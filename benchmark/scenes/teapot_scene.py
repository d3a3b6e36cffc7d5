"""``teapot_scene``, the reference renderer's scene 1
(``Raytracing_n.cpp:306-377``): two Utah teapots tessellated from
Newell's Bézier patches, one a mirror and one gold Beckmann, a glass
sphere holding a blue isotropic medium, a Lambertian floor, a rect light
and an image-textured environment dome.

A frozen copy of ``srt_tpu_torch/scene/library.py:165-224`` and of the
tessellation of ``srt_tpu_torch/scene/teapot.py`` (``teapot_data.npz``
beside this file holds the same 32x16 patch indices and 306 control
points). The bunny and the dragon (``models/bunny.ply``,
``models/dragon.ply``) and the dome's ``environment_map/sky_2.png`` are
not in the repository: the meshes are left out and the dome shows the
library's 8x8 stand-in, as the library does without them. The triangles
come as a soup in the order they were added, with no acceleration
tables. Nothing here is seeded.
"""
from __future__ import annotations

import os

import numpy as np

from benchmark.reference.camera import Camera, camera_arrays
from benchmark.scenes.builder import Mesh, SceneArrays, rotation_x, stand_in

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "teapot_data.npz")


def _bernstein(t: np.ndarray) -> np.ndarray:
    """Cubic Bernstein basis: (n,) -> (n, 4)."""
    t = np.asarray(t, np.float64)
    u = 1.0 - t
    return np.stack([u ** 3, 3 * t * u ** 2, 3 * t ** 2 * u, t ** 3], axis=-1)


def teapot(scale: float = 1.0, divs: int = 100) -> Mesh:
    """The teapot's soup (``teapot.h:10-172``): each (divs x divs) quad
    (v0, v1, v2, v3) of each of the 32 patches emits (v0, v1, v2) and (v0,
    v2, v3), in float64, uvs the patch parameters, no normals (the
    reference shades flat); zero-area triangles of collapsed patch edges
    are dropped, as the port's tessellation drops them."""
    data = np.load(_DATA)
    cps = data["vertices"]                                       # (306, 3)
    cp = cps[data["patches"] - 1].reshape(32, 4, 4, 3).astype(np.float64)
    t = np.linspace(0.0, 1.0, divs + 1)
    b = _bernstein(t)
    grid = np.einsum("ja,ib,pabc->pjic", b, b, cp)   # (32, G, G, 3) [v][u]

    g = divs + 1
    j, i = np.meshgrid(np.arange(divs), np.arange(divs), indexing="ij")
    v0 = (j * g + i).reshape(-1)
    v1 = (j * g + i + 1).reshape(-1)
    v2 = ((j + 1) * g + i + 1).reshape(-1)
    v3 = ((j + 1) * g + i).reshape(-1)
    tri_idx = np.concatenate(
        [np.stack([v0, v1, v2], -1), np.stack([v0, v2, v3], -1)])
    pos = grid.reshape(32, g * g, 3)[:, tri_idx].reshape(-1, 3, 3) * scale

    uu, vv = np.meshgrid(t, t, indexing="xy")
    uvflat = np.stack([uu, vv], -1).reshape(g * g, 2)
    uv = np.broadcast_to(uvflat[tri_idx], (32,) + tri_idx.shape + (2,))
    uv = uv.reshape(-1, 3, 2)

    area2 = np.linalg.norm(
        np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]), axis=1)
    keep = area2 > 1e-12 * max(scale, 1.0) ** 2
    return Mesh(np.ascontiguousarray(pos[keep], np.float32),
                np.ascontiguousarray(uv[keep], np.float32), None)


def make(aspect: float = 1.0, divs: int = 100) -> tuple[dict, dict]:
    """The scene's arrays and its camera's; ``divs`` sets the
    tessellation (``teapot.h:77``; 100 gives 639,200 triangles a
    teapot)."""
    lookfrom = (100.0, 800.0, -400.0)
    b = SceneArrays()

    light = b.diffuse_light(b.constant((40.0, 40.0, 40.0)))
    lam_brown = b.lambertian(b.constant((0.426, 0.3, 0.254)))
    b.oren_nayar(b.constant((1.0, 1.0, 1.0)), 10.0)      # the bunny's
    beck_gold = b.beckmann(b.constant((0.945, 0.75, 0.336)), 0.01, 0.05)
    b.beckmann(b.constant((0.8, 0.85, 0.88)), 0.1, 0.1)  # the dragon's
    mirror = b.metal((0.9, 0.9, 0.9), 0.0)

    lid = b.xz_rect(3, 153, 217, 343, 800, light, flip=True)     # :336
    b.xz_rect(0, 555, 0, 555, 0, lam_brown)                      # :338
    # the dome (library.py:98-104), sky_2.png's stand-in
    b.sphere(lookfrom, 10000.0, b.diffuse_light(
        b.image(stand_in((0.6, 0.7, 0.9)))), flip=True)

    pot = teapot(scale=40.0, divs=divs)                          # :348-354
    b.trimesh(pot, mirror, rotate=rotation_x(90.0), translate=(200, 0, 250))
    b.trimesh(pot, beck_gold, rotate=rotation_x(90.0),
              translate=(360, 0, 150))
    b.sphere((280, 30, 70), 30.0, b.dielectric(1.5))              # :360
    b.medium_sphere((280, 30, 70), 30.0, 0.2,
                    b.constant((0.2, 0.4, 0.9)))                  # :362
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    return b.build(), camera_arrays(cam)
