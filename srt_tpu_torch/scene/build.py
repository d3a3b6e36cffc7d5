"""Host-side scene construction (counterpart of ``srt_tpu/scene/build.py``).

Covers what the port's slices render: spheres (static, moving and env
domes) and a BVH over them when there are many, axis-aligned rects,
boxes, triangles and triangle meshes with their BVH and its two-level
clustering, sphere, box and mesh-bounded media, constant, checker, noise
and image textures, Lambertian, Oren–Nayar, Beckmann, metal, dielectric,
isotropic, MERL measured and diffuse-light materials, and rect and sphere
lights. The tables, the Perlin tables among them, are packed in numpy
exactly as the JAX builder packs them, then moved to one device.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from srt_tpu_torch.accel.bvh import build_bvh
from srt_tpu_torch.accel.cluster import build_clusters
from srt_tpu_torch.scene.ir import (LightKind, MaterialType, TextureType,
                                    TorchScene)

#: the seed of the Perlin tables, the JAX builder's default
#: (``srt_tpu/scene/build.py:42,450``)
PERLIN_SEED = 7


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


#: the two-level BVH's caps on a cluster's nodes and triangles, the JAX
#: package's (``srt_tpu/scene/build.py:47-48``)
CLUSTER_NODE_CAP = 2048
CLUSTER_TRI_CAP = 4096


def triangle_tables(p: np.ndarray, uv: np.ndarray, n: np.ndarray,
                    tm: np.ndarray, node_cap: int = CLUSTER_NODE_CAP,
                    tri_cap: int = CLUSTER_TRI_CAP,
                    seconds: dict | None = None) -> dict:
    """A scene's triangle tables from its soup in the order it was added:
    corners ``p`` (T, 3, 3), uvs ``uv`` (T, 3, 2), normals ``n`` (T, 3, 3)
    and materials ``tm`` (T,). Returns the ``TorchScene`` fields as numpy
    arrays: the soup in BVH order (``tri_*``), the BVH over it (``bvh_*``,
    leaves of at most 4) and, where there are triangles, its clusters
    (``top_*``, ``cl_*``) under the caps. ``seconds``, if given, receives
    the host seconds of ``bvh`` and of ``clusters``."""
    t0 = time.perf_counter()
    bvh, order = build_bvh(p, leaf_size=4)
    t1 = time.perf_counter()
    p, uv, n, tm = p[order], uv[order], n[order], tm[order]
    clusters = {}
    if len(p):
        clusters = build_clusters(bvh, p[:, 0], p[:, 1], p[:, 2],
                                  node_cap=node_cap,
                                  tri_cap=tri_cap)._asdict()
    if seconds is not None:
        seconds.update(bvh=t1 - t0, clusters=time.perf_counter() - t1)
    return dict(tri_p0=p[:, 0], tri_p1=p[:, 1], tri_p2=p[:, 2], tri_uv=uv,
                tri_n=n, tri_mat=tm, bvh_lo=bvh.lo, bvh_hi=bvh.hi,
                bvh_skip=bvh.skip, bvh_first=bvh.first, bvh_count=bvh.count,
                **clusters)


@dataclass
class SceneBuilder:
    """Accumulates primitives/materials/textures, then :meth:`build`
    packs them into a :class:`TorchScene`; its triangles' tables come
    from :func:`triangle_tables`, with the cluster caps of the two-level
    BVH, the JAX package's (``srt_tpu/scene/build.py:47-48``).
    A scene with at least ``sphere_bvh_min`` spheres that are not
    environment domes also gets a sphere BVH (:func:`sphere_bvh`, JAX's
    threshold of 64). ``seconds`` holds the last build's host seconds a
    step: ``bvh`` (both trees), ``clusters`` and ``upload`` (the tables
    onto the device).
    """

    sphere_bvh_min: int = 64
    cluster_node_cap: int = CLUSTER_NODE_CAP
    cluster_tri_cap: int = CLUSTER_TRI_CAP
    seconds: dict = field(default_factory=dict, init=False)
    _tex_type: list = field(default_factory=list)
    _tex_color: list = field(default_factory=list)
    _tex_color2: list = field(default_factory=list)
    _tex_scale: list = field(default_factory=list)
    _tex_img: list = field(default_factory=list)
    _atlas: list = field(default_factory=list)
    _atlas_len: int = 0
    _mat_type: list = field(default_factory=list)
    _mat_tex: list = field(default_factory=list)
    _mat_params: list = field(default_factory=list)
    _sph: list = field(default_factory=list)
    _rect: list = field(default_factory=list)
    _tris: list = field(default_factory=list)   # (p, uv, n, mat) chunks
    _med: list = field(default_factory=list)
    _med_tris: list = field(default_factory=list)  # (world tris, medium)
    _merl: list = field(default_factory=list)   # (3, N) measured tables
    _lights: list = field(default_factory=list)

    # ------------------------------------------------------------------ tex
    def constant(self, color) -> int:
        return self._push_tex(TextureType.CONSTANT, color=color)

    def checker(self, even, odd) -> int:
        return self._push_tex(TextureType.CHECKER, color=even, color2=odd)

    def noise(self, scale: float) -> int:
        return self._push_tex(TextureType.NOISE, scale=scale)

    def image(self, pixels: np.ndarray) -> int:
        """Register an image texture. ``pixels``: (ny, nx, 3) uint8 or f32."""
        px = np.asarray(pixels)
        if px.dtype == np.uint8:
            px = px.astype(np.float32) / 255.0
        if px.ndim == 2:
            px = np.repeat(px[:, :, None], 3, axis=2)
        px = np.ascontiguousarray(px[:, :, :3], np.float32)
        ny, nx, _ = px.shape
        offset = self._atlas_len
        self._atlas.append(px.reshape(-1))
        self._atlas_len += px.size
        return self._push_tex(TextureType.IMAGE, img=(offset, nx, ny))

    def _push_tex(self, ttype, color=(0, 0, 0), color2=(0, 0, 0),
                  scale=0.0, img=(0, 0, 0)) -> int:
        self._tex_type.append(int(ttype))
        self._tex_color.append(np.asarray(color, np.float32))
        self._tex_color2.append(np.asarray(color2, np.float32))
        self._tex_scale.append(float(scale))
        self._tex_img.append(np.asarray(img, np.int32))
        return len(self._tex_type) - 1

    # ------------------------------------------------------------------ mat
    def _push_mat(self, mtype, tex, params=(0.0, 0.0, 0.0, 0.0)) -> int:
        self._mat_type.append(int(mtype))
        self._mat_tex.append(int(tex))
        self._mat_params.append(np.asarray(params, np.float32))
        return len(self._mat_type) - 1

    def lambertian(self, tex: int) -> int:
        return self._push_mat(MaterialType.LAMBERTIAN, tex)

    def oren_nayar(self, tex: int, sigma_deg: float) -> int:
        # A/B precomputation identical to material.h:129-133.
        s = sigma_deg / 180.0 * math.pi
        a = 1.0 - 0.5 * s * s / (s * s + 0.33)
        b = 0.45 * s * s / (s * s + 0.09)
        return self._push_mat(MaterialType.OREN_NAYAR, tex, (a, b, 0, 0))

    def beckmann(self, tex: int, roughx: float, roughy: float) -> int:
        ax = roughness_to_alpha(roughx)
        ay = roughness_to_alpha(roughy)
        return self._push_mat(MaterialType.BECKMANN, tex, (ax, ay, 0, 0))

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        tex = self.constant(albedo)
        return self._push_mat(MaterialType.METAL, tex,
                              (min(fuzz, 1.0), 0, 0, 0))

    def dielectric(self, ref_idx: float) -> int:
        tex = self.constant((1.0, 1.0, 1.0))
        return self._push_mat(MaterialType.DIELECTRIC, tex,
                              (ref_idx, 0, 0, 0))

    def diffuse_light(self, tex: int) -> int:
        return self._push_mat(MaterialType.DIFFUSE_LIGHT, tex)

    def isotropic(self, tex: int) -> int:
        return self._push_mat(MaterialType.ISOTROPIC, tex)

    def merl(self, table: np.ndarray, albedo) -> int:
        """Measured-BRDF material; ``table`` is (3, N) f32 in MERL layout
        (already scaled), from :func:`srt_tpu_torch.io.merl.read_merl`;
        its index in the stacked ``merl`` field is parameter 0."""
        tex = self.constant(albedo)
        self._merl.append(np.asarray(table, np.float32))
        return self._push_mat(MaterialType.MERL, tex,
                              (float(len(self._merl) - 1), 0, 0, 0))

    # ------------------------------------------------------------------ geo
    def sphere(self, center, radius, mat, flip=False, env=False,
               center1=None, t0=0.0, t1=1.0) -> int:
        """A sphere; with ``center1`` a moving one, at ``center`` at time
        ``t0`` and ``center1`` at ``t1`` (``moving_sphere.h``)."""
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
        ``as_tris=True`` twelve outward-wound BVH triangles."""
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

    def triangles(self, p: np.ndarray, mat: int, uv=None, n=None) -> None:
        """Add world-space triangles ``p`` (T, 3, 3); without ``n`` every
        vertex takes the face's geometric normal, without ``uv`` zeros."""
        p = np.asarray(p, np.float32)
        t = len(p)
        if n is None:
            n = _flat_normals(p)
        if uv is None:
            uv = np.zeros((t, 3, 2), np.float32)
        self._tris.append((p, np.asarray(uv, np.float32),
                           np.asarray(n, np.float32),
                           np.full(t, int(mat), np.int32)))

    def trimesh(self, mesh, mat: int, scale=(1.0, 1.0, 1.0),
                rotate: np.ndarray | None = None,
                translate=(0.0, 0.0, 0.0), flip_winding: bool = False,
                flip_uvs: bool = False) -> None:
        """Add a :class:`~srt_tpu_torch.io.mesh.TriMesh` soup, baking
        scale, rotate, translate into world space (the reference's
        ``translate(rotate(bvh_node(model)))``, ``Raytracing_n.cpp:642``);
        a mesh without normals shades flat."""
        if isinstance(scale, (int, float)):
            scale = (scale, scale, scale)
        m = mesh.transformed(scale=scale, rotate=rotate, translate=translate,
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
        self._med.append((0, np.asarray(center, np.float32), float(radius),
                          np.zeros(3, np.float32), float(density), mat))

    def medium_box(self, p0, p1, density, albedo_tex: int) -> None:
        """A constant medium bounded by an axis-aligned box, the convex
        case of ``constant_medium.h:4-50``, stored as centre and half
        extents."""
        mat = self.isotropic(albedo_tex)
        p0 = np.asarray(p0, np.float32)
        p1 = np.asarray(p1, np.float32)
        self._med.append((1, 0.5 * (p0 + p1), 0.0, np.abs(0.5 * (p1 - p0)),
                          float(density), mat))

    def medium_mesh(self, tri_verts: np.ndarray, density, albedo_tex: int,
                    scale=(1.0, 1.0, 1.0), rotate: np.ndarray | None = None,
                    translate=(0.0, 0.0, 0.0)) -> None:
        """A constant medium bounded by a convex triangle mesh, the
        reference's ``constant_medium`` over a model
        (``srt_tpu/scene/build.py:307-323``; ``triangle.h:108-115``'s
        two-sided path). ``tri_verts``: (T, 3, 3) in object space, scaled,
        rotated and translated into the world as :meth:`trimesh` does."""
        mat = self.isotropic(albedo_tex)
        self._med.append((2, np.zeros(3, np.float32), 0.0,
                          np.zeros(3, np.float32), float(density), mat))
        p = np.asarray(tri_verts, np.float32) * np.asarray(scale, np.float32)
        if rotate is not None:
            p = p @ np.asarray(rotate, np.float32).T
        p = p + np.asarray(translate, np.float32)
        self._med_tris.append((p, len(self._med) - 1))

    def light_rect(self, rect_id: int) -> None:
        """NEE light registration (the reference's hlist)."""
        self._lights.append((LightKind.RECT, rect_id))

    def light_sphere(self, sph_id: int) -> None:
        self._lights.append((LightKind.SPHERE, sph_id))

    # ---------------------------------------------------------------- build
    def build(self, device="cuda") -> TorchScene:
        f32, i32 = np.float32, np.int32
        if not self._tex_type:
            self.constant((0.0, 0.0, 0.0))
        if not self._mat_type:
            self._push_mat(MaterialType.LAMBERTIAN, 0)

        def arr(rows, dtype, shape_tail):
            if rows:
                return np.asarray(rows, dtype)
            return np.zeros((0,) + shape_tail, dtype)

        s_c0 = arr([s[0] for s in self._sph], f32, (3,))
        if self._tris:
            p, uv, n, tm = (np.concatenate([t[k] for t in self._tris])
                            for k in range(4))
        else:
            p, uv, n = (np.zeros((0, 3, k), f32) for k in (3, 2, 3))
            tm = np.zeros((0,), i32)
        seconds: dict = {}
        tris = triangle_tables(p, uv, n, tm, node_cap=self.cluster_node_cap,
                               tri_cap=self.cluster_tri_cap, seconds=seconds)
        t0 = time.perf_counter()
        sbvh = sphere_bvh(self._sph, self.sphere_bvh_min)
        seconds["bvh"] += time.perf_counter() - t0
        atlas = (np.concatenate(self._atlas) if self._atlas
                 else np.zeros((0,), f32))
        # Packed rgb8 twin: exact iff every value is a u8/255 multiple.
        atlas_u32 = None
        if atlas.size:
            q = np.round(atlas * 255.0)
            if (q.astype(f32) / np.float32(255.0) == atlas).all():
                rgb = q.astype(np.uint32).reshape(-1, 3)
                atlas_u32 = ((rgb[:, 0] << 16) | (rgb[:, 1] << 8)
                             | rgb[:, 2]).astype(i32)
        # the Perlin tables as the JAX builder draws them (perlin.h:94-97
        # draws them from drand48 at static init; the seed is pinned)
        prng = np.random.default_rng(PERLIN_SEED)
        pv = prng.uniform(-1.0, 1.0, (256, 3)).astype(f32)
        pv /= np.maximum(np.linalg.norm(pv, axis=1, keepdims=True), 1e-9)
        perm = np.stack([prng.permutation(256) for _ in range(3)]).astype(i32)
        med_tris = {}
        if self._med_tris:
            mp = np.concatenate([t[0] for t in self._med_tris])
            med_tris = dict(
                med_tri_p0=mp[:, 0], med_tri_p1=mp[:, 1], med_tri_p2=mp[:, 2],
                med_tri_mid=np.concatenate([np.full(len(t[0]), t[1], i32)
                                            for t in self._med_tris]))
        tables = dict(
            sph_center0=s_c0,
            sph_center1=arr([s[5] for s in self._sph], f32, (3,)),
            sph_times=arr([s[6] for s in self._sph], f32, (2,)),
            sph_radius=arr([s[1] for s in self._sph], f32, ()),
            sph_mat=arr([s[2] for s in self._sph], i32, ()),
            sph_flip=arr([s[3] for s in self._sph], bool, ()),
            sph_env=arr([s[4] for s in self._sph], bool, ()),
            rect_axis=arr([r[0] for r in self._rect], i32, ()),
            rect_bounds=arr([r[1] for r in self._rect], f32, (4,)),
            rect_k=arr([r[2] for r in self._rect], f32, ()),
            rect_mat=arr([r[3] for r in self._rect], i32, ()),
            rect_flip=arr([r[4] for r in self._rect], bool, ()),
            **tris, med_kind=arr([m[0] for m in self._med], i32, ()),
            med_center=arr([m[1] for m in self._med], f32, (3,)),
            med_radius=arr([m[2] for m in self._med], f32, ()),
            med_half=arr([m[3] for m in self._med], f32, (3,)),
            med_density=arr([m[4] for m in self._med], f32, ()),
            med_mat=arr([m[5] for m in self._med], i32, ()),
            mat_type=arr(self._mat_type, i32, ()),
            mat_tex=arr(self._mat_tex, i32, ()),
            mat_params=arr(self._mat_params, f32, (4,)),
            tex_type=arr(self._tex_type, i32, ()),
            tex_color=arr(self._tex_color, f32, (3,)),
            tex_color2=arr(self._tex_color2, f32, (3,)),
            tex_scale=arr(self._tex_scale, f32, ()),
            tex_img=arr(self._tex_img, i32, (3,)),
            atlas=atlas, perlin_vec=pv, perlin_perm=perm,
            merl=(np.stack(self._merl) if self._merl
                  else np.zeros((0, 3, 1), f32)),
            light_kind=arr([int(li[0]) for li in self._lights], i32, ()),
            light_index=arr([li[1] for li in self._lights], i32, ()),
            atlas_u32=atlas_u32, **med_tris, **sbvh)
        t3 = time.perf_counter()
        scene = TorchScene(**{
            k: None if v is None else
            torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in tables.items()})
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
        self.seconds = dict(seconds, upload=time.perf_counter() - t3)
        return scene


def sphere_bvh(spheres: list, min_count: int = 64) -> dict:
    """The sphere BVH's tables (``sbvh_*`` and ``sph_env_ids``) over the
    builder's spheres, as the JAX builder makes them
    (``srt_tpu/scene/build.py:399-426``), or ``{}`` below ``min_count``
    spheres that are not environment domes. The triangle builder
    (:func:`accel.bvh.build_bvh`) takes one synthetic triangle a sphere,
    ``(lo, hi, (lo + hi) / 2)`` of the box around its centre at both ends
    of the shutter interval, so the triangle's box and centroid are the
    sphere's; the tree's leaves hold original sphere ids."""
    if len(spheres) < min_count:
        return {}
    c0 = np.stack([s[0] for s in spheres])
    c1 = np.stack([s[5] for s in spheres])
    r = np.asarray([s[1] for s in spheres], np.float32)[:, None]
    env = np.asarray([s[4] for s in spheres], bool)
    lo = np.minimum(c0, c1) - r
    hi = np.maximum(c0, c1) + r
    ids = np.nonzero(~env)[0].astype(np.int64)
    if len(ids) < min_count:
        return {}
    synth = np.stack([lo[ids], hi[ids], 0.5 * (lo[ids] + hi[ids])],
                     axis=1).astype(np.float32)
    tree, order = build_bvh(synth, leaf_size=4)
    return dict(sbvh_lo=tree.lo, sbvh_hi=tree.hi, sbvh_skip=tree.skip,
                sbvh_first=tree.first, sbvh_count=tree.count,
                sbvh_ids=ids[order].astype(np.int32),
                sph_env_ids=np.nonzero(env)[0].astype(np.int32))


def roughness_to_alpha(roughness: float) -> float:
    """PBRT roughness remap (math of ``microfacet_distribution.h:139-144``)."""
    r = max(roughness, 1e-3)
    x = math.log(r)
    return (1.62162 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)
