"""Scenes inside srt_tpu_torch's coverage, built the same way by either
package's SceneBuilder. ``lit_room``: two rect lights (one
image-textured), no environment dome (so rays miss), a flipped-normal
sphere, Beckmann spheres from near-mirror to rough, an Oren–Nayar floor.
``lit_room_media``: the same room with a sphere medium and a box medium,
a metal and a glass sphere, and an image-textured Lambertian sphere.
Two scenes the bounce kernels' gate refuses, so both engines shade them
with the plain bounce: ``medium_room``, a rect light seen through a
constant medium bounded by a box or by the same box as 12 triangles
(``tests/test_render.py:192-220``), and ``cornell_tiled``, cornell_boxes
with its back wall tiled into rects, past the kernels' 64 rects. And
``write_blob_ply``, a seeded closed mesh written as the PLY a scanned
mesh asset would be, and ``merl_table``, a seeded smooth MERL table."""
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


#: ``medium_room``'s box and its cameras: outside the medium, and inside
#: it (a camera ray's entry clamps to 0, ``constant_medium.h:23``)
MEDIUM_BOX = ((-4.0, -4.0, -14.0), (4.0, 4.0, -6.0))
MEDIUM_CAMERA = dict(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=40.0,
                     aspect=1.0)
MEDIUM_CAMERA_INSIDE = dict(lookfrom=(0, 0, -10), lookat=(0, 0, -20),
                            vfov=40.0, aspect=1.0)


def box_tris(lo, hi) -> np.ndarray:
    """The 12 triangles (12, 3, 3) of the box ``lo``-``hi``."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    c = np.array([[x0, y0, z0], [x1, y0, z0], [x0, y1, z0],
                  [x1, y1, z0], [x0, y0, z1], [x1, y0, z1],
                  [x0, y1, z1], [x1, y1, z1]], np.float32)
    quads = np.array([[0, 2, 3, 1], [4, 5, 7, 6], [0, 1, 5, 4],
                      [2, 6, 7, 3], [0, 4, 6, 2], [1, 3, 7, 5]])
    return c[np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])]


def medium_room(b, kind: str):
    """A rect light behind a density-0.5 grey medium bounded by
    :data:`MEDIUM_BOX` as a box (``kind`` "box") or as its triangles
    ("mesh"); returns the builder."""
    lid = b.xy_rect(-5, 5, -5, 5, -20, b.diffuse_light(b.constant((4, 4, 4))))
    albedo = b.constant((0.2, 0.2, 0.2))
    if kind == "box":
        b.medium_box(*MEDIUM_BOX, 0.5, albedo)
    else:
        b.medium_mesh(box_tris(*MEDIUM_BOX), 0.5, albedo)
    b.light_rect(lid)
    return b


#: cornell_boxes' camera (``srt_tpu/scene/library.py:258-259``)
CORNELL_CAMERA = dict(lookfrom=(278, 278, -800), lookat=(278, 278, 0),
                      vfov=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)


def cornell_tiled(b, tiles: int = 8):
    """cornell_boxes (``srt_tpu/scene/library.py:234-260``) with its back
    wall as ``tiles`` x ``tiles`` rects that cover it exactly: 5 + 64
    rects at the default, past the bounce kernels' cap of 64. Returns
    the builder."""
    red = b.lambertian(b.constant((0.65, 0.05, 0.05)))
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    green = b.lambertian(b.constant((0.12, 0.45, 0.15)))
    light = b.diffuse_light(b.constant((15.0, 15.0, 15.0)))
    b.yz_rect(0, 555, 0, 555, 555, green, flip=True)
    b.yz_rect(0, 555, 0, 555, 0, red)
    lid = b.xz_rect(213, 343, 227, 332, 554, light, flip=True)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xz_rect(0, 555, 0, 555, 555, white, flip=True)
    edges = np.linspace(0.0, 555.0, tiles + 1)
    for i in range(tiles):
        for j in range(tiles):
            b.xy_rect(edges[i], edges[i + 1], edges[j], edges[j + 1], 555,
                      white, flip=True)
    b.box((130, 0, 65), (295, 165, 230), white, as_tris=True)
    b.box((265, 0, 295), (430, 330, 460), white, as_tris=True)
    b.light_rect(lid)
    return b


def write_blob_ply(path: str, n_lat: int, n_lon: int, seed: int,
                   centre=(-0.02, 0.11, 0.0), radius: float = 0.07,
                   binary: bool = True, quads: bool = False) -> int:
    """A seeded closed blob -- a UV sphere of ``n_lat`` rings and
    ``n_lon`` segments, each vertex's radius jittered by up to 20% -- as a
    PLY with the Stanford bunny's vertex properties (``x y z confidence
    intensity``, float32) and a ``uchar``/``int`` face list: binary
    little-endian or ASCII, and with ``quads`` the faces between rings as
    quads. The default centre and radius put it where the bunny sits in
    bunny.ply's own units (about 0.15 across, on y = 0.04). Returns its
    triangle count, ``2 n_lon (n_lat - 1)``."""
    r = np.random.default_rng(seed)
    th = np.linspace(0.0, np.pi, n_lat + 1)[1:-1]
    ph = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.sin(th)[:, None] * np.cos(ph),
                     np.cos(th)[:, None] * np.ones_like(ph),
                     np.sin(th)[:, None] * np.sin(ph)], -1).reshape(-1, 3)
    dirs = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    rad = radius * (1.0 + 0.2 * r.uniform(-1.0, 1.0, len(dirs)))
    verts = (np.asarray(centre) + dirs * rad[:, None]).astype(np.float32)
    last = len(verts) - 1

    def vid(i, j):
        return 1 + i * n_lon + j % n_lon

    faces = [[0, vid(0, j + 1), vid(0, j)] for j in range(n_lon)]
    for i in range(n_lat - 2):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            faces += [[a, b, c, d]] if quads else [[a, b, c], [a, c, d]]
    faces += [[last, vid(n_lat - 2, j), vid(n_lat - 2, j + 1)]
              for j in range(n_lon)]
    extra = r.uniform(0.0, 1.0, (len(verts), 2)).astype(np.float32)
    header = ("ply\nformat " + ("binary_little_endian" if binary
                                 else "ascii") + " 1.0\n"
              f"element vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property float confidence\nproperty float intensity\n"
              f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.concatenate([verts, extra], 1).astype("<f4")
                    .tobytes())
            for face in faces:
                f.write(np.uint8(len(face)).tobytes())
                f.write(np.asarray(face, "<i4").tobytes())
        else:
            for v, e in zip(verts, extra):
                f.write((" ".join(repr(float(x)) for x in (*v, *e))
                         + "\n").encode())
            for face in faces:
                f.write((f"{len(face)} " + " ".join(map(str, face))
                         + "\n").encode())
    return 2 * n_lon * (n_lat - 1)


def merl_table(seed: int) -> np.ndarray:
    """A seeded smooth (3, 90*90*180) MERL table, unscaled (the values
    ``write_merl`` stores): a positive low-frequency field over the
    half/diff grid, each channel its own."""
    r = np.random.default_rng(seed)
    th, td, pd = np.meshgrid(np.linspace(0, 1, 90), np.linspace(0, 1, 90),
                             np.linspace(0, 1, 180), indexing="ij")
    out = []
    for _ in range(3):
        a, b, c = r.uniform(0.5, 2.0, 3)
        out.append(150.0 * (1.5 + np.cos(a * np.pi * th)
                            * np.cos(b * np.pi * td)
                            + 0.3 * np.sin(2 * np.pi * c * pd)))
    return np.stack(out).reshape(3, -1)
