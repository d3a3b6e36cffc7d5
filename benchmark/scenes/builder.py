"""The scene arrays, packed in numpy: a frozen copy of
``srt_tpu_torch/scene/build.py:SceneBuilder`` for the families the plain
reference holds (constant, checker and image textures; Lambertian,
Oren–Nayar, Beckmann, metal, dielectric, isotropic and diffuse-light
materials; static and moving spheres, environment domes, axis-aligned
rects and boxes; triangles and triangle meshes; media bounded by a sphere
or a box; rect lights), with the Perlin tables as it draws them.

:meth:`SceneArrays.build` returns a dict of the ``TorchScene`` fields
(``srt_tpu_torch/scene/ir.py``), the form
``srt_tpu_torch.convert.scene_from_arrays`` takes and the plain reference
reads (:class:`benchmark.reference.scene.Scene`). A scene without
triangles gets the builder's empty triangle and BVH tables. A scene with
triangles gets its soup in the order it was added and no acceleration
tables: deriving the BVH and its clusters from the soup is the program's
work, as the packed sphere records are. The sphere BVH, which the builder
adds past 64 spheres for the plain bounce's walk when a render turns it
on, is left out: the benchmark's cells never turn it on.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

# srt_tpu_torch/scene/ir.py's ids
(LAMBERTIAN, OREN_NAYAR, BECKMANN, METAL, DIELECTRIC, DIFFUSE_LIGHT,
 ISOTROPIC) = range(7)
CONSTANT, CHECKER, NOISE, IMAGE = range(4)
RECT_LIGHT = 0
MEDIUM_SPHERE, MEDIUM_BOX = 0, 1
#: the seed of the Perlin tables (``srt_tpu_torch/scene/build.py:29``)
PERLIN_SEED = 7


def stand_in(color, size: int = 8) -> np.ndarray:
    """The constant image an absent asset becomes
    (``srt_tpu_torch/io/assets.py:load_image_asset``): (size, size, 3)
    uint8."""
    c = (np.asarray(color, np.float32) * 255).astype(np.uint8)
    return np.broadcast_to(c, (size, size, 3)).copy()


def roughness_to_alpha(roughness: float) -> float:
    """PBRT roughness remap (``microfacet_distribution.h:139-144``)."""
    r = max(roughness, 1e-3)
    x = math.log(r)
    return (1.62162 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


def rotation_y(angle_deg: float) -> np.ndarray:
    """World-space matrix of the reference's ``rotate_y`` instancing
    (``hitable.h:109-132``)."""
    r = math.radians(angle_deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)


def rotation_x(angle_deg: float) -> np.ndarray:
    """World-space matrix of ``rotate_x`` (``hitable.h:151-203``)."""
    r = math.radians(angle_deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, s], [0.0, -s, c]], np.float32)


def _flat_normals(p: np.ndarray) -> np.ndarray:
    """Every vertex takes its face's geometric normal: (T, 3, 3)."""
    gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    gn = gn / np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
    return np.repeat(gn[:, None, :], 3, axis=1)


class Mesh(NamedTuple):
    """A triangle soup in object space (``srt_tpu_torch/io/mesh.py:
    TriMesh``): corners (T, 3, 3) float32, and per-corner uvs (T, 3, 2)
    and normals (T, 3, 3), each None where the mesh has none."""
    positions: np.ndarray
    uvs: np.ndarray | None = None
    normals: np.ndarray | None = None


def transformed(mesh, scale=(1.0, 1.0, 1.0), rotate=None,
                translate=(0.0, 0.0, 0.0), flip_winding=False,
                flip_uvs=False) -> Mesh:
    """``mesh`` (anything with ``positions``, ``uvs`` and ``normals``)
    with scale, then rotate, then translate baked in, and its winding or
    uvs flipped (``TriMesh.transformed``)."""
    p = mesh.positions * np.asarray(scale, np.float32)
    if rotate is not None:
        p = p @ np.asarray(rotate, np.float32).T
    p = p + np.asarray(translate, np.float32)
    n = mesh.normals
    if n is not None and rotate is not None:
        n = n @ np.asarray(rotate, np.float32).T
    uv = mesh.uvs
    if flip_uvs and uv is not None:
        uv = np.stack([uv[..., 0], 1.0 - uv[..., 1]], axis=-1)
    if flip_winding:
        p = p[:, ::-1]
        n = None if n is None else n[:, ::-1]
        uv = None if uv is None else uv[:, ::-1]
    return Mesh(np.ascontiguousarray(p, np.float32),
                None if uv is None else np.ascontiguousarray(uv, np.float32),
                None if n is None else np.ascontiguousarray(n, np.float32))


class SceneArrays:
    """Accumulates textures, materials, spheres, rects, triangles, media
    and lights in the order a library function adds them, as
    ``SceneBuilder`` does."""

    def __init__(self):
        self._tex = []       # (type, color, color2, scale, img)
        self._atlas = []
        self._atlas_len = 0
        self._mat = []       # (type, tex, params)
        self._sph = []       # (c0, radius, mat, flip, env, c1, times)
        self._rect = []      # (axis, bounds, k, mat, flip)
        self._tris = []      # (p, uv, n, mat) chunks
        self._med = []       # (kind, center, radius, half, density, mat)
        self._lights = []    # (kind, index)

    # textures (build.py:90-126)
    def _push_tex(self, ttype, color=(0, 0, 0), color2=(0, 0, 0), scale=0.0,
                  img=(0, 0, 0)) -> int:
        self._tex.append((int(ttype), np.asarray(color, np.float32),
                          np.asarray(color2, np.float32), float(scale),
                          np.asarray(img, np.int32)))
        return len(self._tex) - 1

    def constant(self, color) -> int:
        return self._push_tex(CONSTANT, color=color)

    def checker(self, even, odd) -> int:
        return self._push_tex(CHECKER, color=even, color2=odd)

    def image(self, pixels: np.ndarray) -> int:
        px = np.asarray(pixels)
        if px.dtype == np.uint8:
            px = px.astype(np.float32) / 255.0
        px = np.ascontiguousarray(px[:, :, :3], np.float32)
        ny, nx, _ = px.shape
        offset = self._atlas_len
        self._atlas.append(px.reshape(-1))
        self._atlas_len += px.size
        return self._push_tex(IMAGE, img=(offset, nx, ny))

    # materials (build.py:128-170)
    def _push_mat(self, mtype, tex, params=(0.0, 0.0, 0.0, 0.0)) -> int:
        self._mat.append((int(mtype), int(tex),
                          np.asarray(params, np.float32)))
        return len(self._mat) - 1

    def lambertian(self, tex: int) -> int:
        return self._push_mat(LAMBERTIAN, tex)

    def oren_nayar(self, tex: int, sigma_deg: float) -> int:
        s = sigma_deg / 180.0 * math.pi          # material.h:129-133
        a = 1.0 - 0.5 * s * s / (s * s + 0.33)
        b = 0.45 * s * s / (s * s + 0.09)
        return self._push_mat(OREN_NAYAR, tex, (a, b, 0, 0))

    def beckmann(self, tex: int, roughx: float, roughy: float) -> int:
        return self._push_mat(BECKMANN, tex, (roughness_to_alpha(roughx),
                                              roughness_to_alpha(roughy),
                                              0, 0))

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        tex = self.constant(albedo)
        return self._push_mat(METAL, tex, (min(fuzz, 1.0), 0, 0, 0))

    def dielectric(self, ref_idx: float) -> int:
        tex = self.constant((1.0, 1.0, 1.0))
        return self._push_mat(DIELECTRIC, tex, (ref_idx, 0, 0, 0))

    def diffuse_light(self, tex: int) -> int:
        return self._push_mat(DIFFUSE_LIGHT, tex)

    def isotropic(self, tex: int) -> int:
        return self._push_mat(ISOTROPIC, tex)

    # geometry (build.py:172-253)
    def sphere(self, center, radius, mat, flip=False, env=False,
               center1=None, t0=0.0, t1=1.0) -> int:
        c0 = np.asarray(center, np.float32)
        c1 = c0 if center1 is None else np.asarray(center1, np.float32)
        self._sph.append((c0, float(radius), int(mat), bool(flip), bool(env),
                          c1, (t0, t1)))
        return len(self._sph) - 1

    def rect(self, axis: int, a0, a1, b0, b1, k, mat, flip=False) -> int:
        self._rect.append((int(axis), (a0, a1, b0, b1), float(k), int(mat),
                           bool(flip)))
        return len(self._rect) - 1

    def xy_rect(self, x0, x1, y0, y1, k, mat, flip=False) -> int:
        return self.rect(0, x0, x1, y0, y1, k, mat, flip)

    def xz_rect(self, x0, x1, z0, z1, k, mat, flip=False) -> int:
        return self.rect(1, x0, x1, z0, z1, k, mat, flip)

    def yz_rect(self, y0, y1, z0, z1, k, mat, flip=False) -> int:
        return self.rect(2, y0, y1, z0, z1, k, mat, flip)

    def box(self, pmin, pmax, mat, as_tris: bool = False) -> None:
        """Axis-aligned box: six rects (``box.h:5-33``), or with
        ``as_tris=True`` twelve outward-wound triangles."""
        x0, y0, z0 = [float(v) for v in pmin]
        x1, y1, z1 = [float(v) for v in pmax]
        if as_tris:
            c = np.array([[x0, y0, z0], [x1, y0, z0], [x0, y1, z0],
                          [x1, y1, z0], [x0, y0, z1], [x1, y0, z1],
                          [x0, y1, z1], [x1, y1, z1]], np.float32)
            # faces -z +z -y +y -x +x
            quads = np.array([[0, 2, 3, 1], [4, 5, 7, 6], [0, 1, 5, 4],
                              [2, 6, 7, 3], [0, 4, 6, 2], [1, 3, 7, 5]])
            f = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
            self.triangles(c[f], mat)
            return
        self.xy_rect(x0, x1, y0, y1, z1, mat)
        self.xy_rect(x0, x1, y0, y1, z0, mat, flip=True)
        self.xz_rect(x0, x1, z0, z1, y1, mat)
        self.xz_rect(x0, x1, z0, z1, y0, mat, flip=True)
        self.yz_rect(y0, y1, z0, z1, x1, mat)
        self.yz_rect(y0, y1, z0, z1, x0, mat, flip=True)

    def triangles(self, p, mat: int, uv=None, n=None) -> None:
        """World-space triangles ``p`` (T, 3, 3); without ``n`` every
        vertex takes the face's geometric normal, without ``uv`` zeros."""
        p = np.asarray(p, np.float32)
        if n is None:
            n = _flat_normals(p)
        if uv is None:
            uv = np.zeros((len(p), 3, 2), np.float32)
        self._tris.append((p, np.asarray(uv, np.float32),
                           np.asarray(n, np.float32),
                           np.full(len(p), int(mat), np.int32)))

    def trimesh(self, mesh, mat: int, scale=(1.0, 1.0, 1.0), rotate=None,
                translate=(0.0, 0.0, 0.0), flip_winding: bool = False,
                flip_uvs: bool = False) -> None:
        """A mesh's soup (:class:`Mesh`) with scale, rotate and translate
        baked into world space (the reference's
        ``translate(rotate(bvh_node(model)))``, ``Raytracing_n.cpp:642``);
        a mesh without normals shades flat."""
        if isinstance(scale, (int, float)):
            scale = (scale, scale, scale)
        m = transformed(mesh, scale=scale, rotate=rotate, translate=translate,
                        flip_winding=flip_winding, flip_uvs=flip_uvs)
        p = m.positions
        n = m.normals if m.normals is not None else _flat_normals(p)
        uv = (m.uvs if m.uvs is not None
              else np.zeros((len(p), 3, 2), np.float32))
        self._tris.append((np.ascontiguousarray(p, np.float32),
                           np.ascontiguousarray(uv, np.float32),
                           np.ascontiguousarray(n, np.float32),
                           np.full(len(p), int(mat), np.int32)))

    def medium_sphere(self, center, radius, density, albedo_tex: int) -> None:
        """A constant medium bounded by a sphere (``constant_medium.h``),
        scattering by an isotropic material of ``albedo_tex``."""
        mat = self.isotropic(albedo_tex)
        self._med.append((MEDIUM_SPHERE, np.asarray(center, np.float32),
                          float(radius), np.zeros(3, np.float32),
                          float(density), mat))

    def medium_box(self, p0, p1, density, albedo_tex: int) -> None:
        """A constant medium bounded by an axis-aligned box, stored as
        centre and half extents."""
        mat = self.isotropic(albedo_tex)
        p0 = np.asarray(p0, np.float32)
        p1 = np.asarray(p1, np.float32)
        self._med.append((MEDIUM_BOX, 0.5 * (p0 + p1), 0.0,
                          np.abs(0.5 * (p1 - p0)), float(density), mat))

    def light_rect(self, rect_id: int) -> None:
        self._lights.append((RECT_LIGHT, rect_id))

    # build.py:325-390, without the acceleration tables
    def build(self) -> dict:
        f32, i32 = np.float32, np.int32

        def arr(rows, dtype, tail):
            return (np.asarray(rows, dtype) if rows
                    else np.zeros((0,) + tail, dtype))

        sph, rect, tex, mat = self._sph, self._rect, self._tex, self._mat
        atlas = (np.concatenate(self._atlas) if self._atlas
                 else np.zeros((0,), f32))
        atlas_u32 = None
        if atlas.size:       # the packed rgb8 twin, exact for u8/255 values
            q = np.round(atlas * 255.0)
            if (q.astype(f32) / np.float32(255.0) == atlas).all():
                rgb = q.astype(np.uint32).reshape(-1, 3)
                atlas_u32 = ((rgb[:, 0] << 16) | (rgb[:, 1] << 8)
                             | rgb[:, 2]).astype(i32)
        prng = np.random.default_rng(PERLIN_SEED)
        pv = prng.uniform(-1.0, 1.0, (256, 3)).astype(f32)
        pv /= np.maximum(np.linalg.norm(pv, axis=1, keepdims=True), 1e-9)
        perm = np.stack([prng.permutation(256) for _ in range(3)]).astype(i32)
        z3 = np.zeros((0, 3), f32)
        zi = np.zeros((0,), i32)
        med = self._med
        tables = dict(
            sph_center0=arr([s[0] for s in sph], f32, (3,)),
            sph_center1=arr([s[5] for s in sph], f32, (3,)),
            sph_times=arr([s[6] for s in sph], f32, (2,)),
            sph_radius=arr([s[1] for s in sph], f32, ()),
            sph_mat=arr([s[2] for s in sph], i32, ()),
            sph_flip=arr([s[3] for s in sph], bool, ()),
            sph_env=arr([s[4] for s in sph], bool, ()),
            rect_axis=arr([r[0] for r in rect], i32, ()),
            rect_bounds=arr([r[1] for r in rect], f32, (4,)),
            rect_k=arr([r[2] for r in rect], f32, ()),
            rect_mat=arr([r[3] for r in rect], i32, ()),
            rect_flip=arr([r[4] for r in rect], bool, ()),
            tri_p0=z3, tri_p1=z3, tri_p2=z3,
            tri_uv=np.zeros((0, 3, 2), f32), tri_n=np.zeros((0, 3, 3), f32),
            tri_mat=zi, bvh_lo=z3, bvh_hi=z3, bvh_skip=zi, bvh_first=zi,
            bvh_count=zi, med_kind=arr([m[0] for m in med], i32, ()),
            med_center=arr([m[1] for m in med], f32, (3,)),
            med_radius=arr([m[2] for m in med], f32, ()),
            med_half=arr([m[3] for m in med], f32, (3,)),
            med_density=arr([m[4] for m in med], f32, ()),
            med_mat=arr([m[5] for m in med], i32, ()),
            mat_type=arr([m[0] for m in mat], i32, ()),
            mat_tex=arr([m[1] for m in mat], i32, ()),
            mat_params=arr([m[2] for m in mat], f32, (4,)),
            tex_type=arr([t[0] for t in tex], i32, ()),
            tex_color=arr([t[1] for t in tex], f32, (3,)),
            tex_color2=arr([t[2] for t in tex], f32, (3,)),
            tex_scale=arr([t[3] for t in tex], f32, ()),
            tex_img=arr([t[4] for t in tex], i32, (3,)),
            atlas=atlas, perlin_vec=pv, perlin_perm=perm,
            merl=np.zeros((0, 3, 1), f32),
            light_kind=arr([li[0] for li in self._lights], i32, ()),
            light_index=arr([li[1] for li in self._lights], i32, ()),
            atlas_u32=atlas_u32)
        if self._tris:
            p, uv, n, tm = (np.concatenate([t[k] for t in self._tris])
                            for k in range(4))
            tables.update(tri_p0=p[:, 0], tri_p1=p[:, 1], tri_p2=p[:, 2],
                          tri_uv=uv, tri_n=n, tri_mat=tm)
            for k in ("bvh_lo", "bvh_hi", "bvh_skip", "bvh_first",
                      "bvh_count"):
                del tables[k]
        return tables
