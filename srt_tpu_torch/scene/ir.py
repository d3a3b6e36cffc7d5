"""Scene tables as tensors (counterpart of ``srt_tpu/scene/ir.py``).

``TorchScene`` carries the fields of the JAX ``Scene`` that the port's
slice reads or that its coverage gate inspects, under the same names and
dtypes, so a JAX scene converts field by field
(:func:`srt_tpu_torch.convert.scene_from_arrays`).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as np
import torch


class MaterialType(enum.IntEnum):
    LAMBERTIAN = 0     # material.h:95-114
    OREN_NAYAR = 1     # material.h:127-149
    BECKMANN = 2       # material.h:151-199 (anisotropic microfacet)
    METAL = 3          # material.h:243-261
    DIELECTRIC = 4     # material.h:282-339
    DIFFUSE_LIGHT = 5  # material.h:341-356 (one-sided emitter)
    ISOTROPIC = 6      # material.h:359-369
    MERL = 7           # material.h:201-241


class TextureType(enum.IntEnum):
    CONSTANT = 0  # texture.h:25-33
    CHECKER = 1   # texture.h:9-23
    NOISE = 2     # texture.h:35-46
    IMAGE = 3     # texture.h:48-70 (nearest-neighbor, y-flip)


class LightKind(enum.IntEnum):
    RECT = 0    # area light sampling, aarect.h:45-60
    SPHERE = 1  # cone sampling, sphere.h:69-86


#: Scene fields whose cotangents exist only on the geometric paths
#: (``srt_tpu/diff/inverse.py:58-64``): the hybrid backward differentiates
#: them, the backward kernel B5 does not.
GEOM_FIELDS = frozenset({
    "sph_center0", "sph_center1", "sph_times", "sph_radius",
    "rect_bounds", "rect_k",
    "tri_p0", "tri_p1", "tri_p2", "tri_uv", "tri_n",
    "med_center", "med_radius", "med_half", "med_density",
    "bvh_lo", "bvh_hi",
})
#: the geometric fields that move a sphere's centre over the shutter
#: interval: optimising one makes the spheres moving (``ir.py:115-125``)
CENTRE_FIELDS = frozenset({"sph_center0", "sph_center1", "sph_times"})
#: the scene fields the hybrid backward differentiates when they require a
#: gradient: the geometry, and the float image atlas, whose texel
#: cotangents come from the replay's gathers (B5 has no atlas input)
REPLAY_FIELDS = GEOM_FIELDS | {"atlas"}


@dataclasses.dataclass
class TorchScene:
    """All-device scene state; every tensor lives on one device."""
    sph_center0: torch.Tensor   # (S, 3) f32
    sph_center1: torch.Tensor   # (S, 3) f32 (== center0 if static)
    sph_times: torch.Tensor     # (S, 2) f32
    sph_radius: torch.Tensor    # (S,) f32
    sph_mat: torch.Tensor       # (S,) i32
    sph_flip: torch.Tensor      # (S,) bool
    sph_env: torch.Tensor       # (S,) bool, always-hit env dome
    rect_axis: torch.Tensor     # (R,) i32: 0=xy 1=xz 2=yz
    rect_bounds: torch.Tensor   # (R, 4) f32 (a0, a1, b0, b1)
    rect_k: torch.Tensor        # (R,) f32
    rect_mat: torch.Tensor      # (R,) i32
    rect_flip: torch.Tensor     # (R,) bool
    tri_p0: torch.Tensor        # (T, 3) f32 triangle vertices, BVH order
    tri_p1: torch.Tensor        # (T, 3) f32
    tri_p2: torch.Tensor        # (T, 3) f32
    tri_uv: torch.Tensor        # (T, 3, 2) f32 per-vertex uv
    tri_n: torch.Tensor         # (T, 3, 3) f32 per-vertex shading normals
    tri_mat: torch.Tensor       # (T,) i32
    # flattened stackless BVH over the triangles (``accel/bvh.py``): on a
    # box hit descend to node i+1, else jump to bvh_skip[i]
    bvh_lo: torch.Tensor        # (B, 3) f32
    bvh_hi: torch.Tensor        # (B, 3) f32
    bvh_skip: torch.Tensor      # (B,) i32 (B = end of the walk)
    bvh_first: torch.Tensor     # (B,) i32 first triangle of a leaf, -1 inner
    bvh_count: torch.Tensor     # (B,) i32 leaf triangle count
    # participating media (constant_medium.h): 0 sphere, 1 box, 2 mesh
    med_kind: torch.Tensor      # (M,) i32
    med_center: torch.Tensor    # (M, 3) f32
    med_radius: torch.Tensor    # (M,) f32 (spheres)
    med_half: torch.Tensor      # (M, 3) f32 half extents (boxes)
    med_density: torch.Tensor   # (M,) f32
    med_mat: torch.Tensor       # (M,) i32 its isotropic material
    mat_type: torch.Tensor      # (Mt,) i32
    mat_tex: torch.Tensor       # (Mt,) i32
    mat_params: torch.Tensor    # (Mt, 4) f32
    tex_type: torch.Tensor      # (Tx,) i32
    tex_color: torch.Tensor     # (Tx, 3) f32
    tex_color2: torch.Tensor    # (Tx, 3) f32 checker odd colour
    tex_scale: torch.Tensor     # (Tx,) f32 noise scale
    tex_img: torch.Tensor       # (Tx, 3) i32 (atlas offset, nx, ny)
    atlas: torch.Tensor         # (A,) f32
    # Perlin tables (perlin.h:28-97), drawn on the host from a fixed seed
    perlin_vec: torch.Tensor    # (256, 3) f32 unit gradients
    perlin_perm: torch.Tensor   # (3, 256) i32 permutations (x, y, z)
    merl: torch.Tensor          # (Nm, 3, n) f32 MERL tables, scales applied
    light_kind: torch.Tensor    # (L,) i32
    light_index: torch.Tensor   # (L,) i32
    atlas_u32: torch.Tensor | None = None   # (A/3,) i32 r<<16|g<<8|b
    # the two-level BVH (``accel/cluster.py``) of a scene with triangles,
    # None without: a top tree whose leaves are clusters, and the clusters'
    # node and triangle blocks padded to the builder's caps
    top_lo: torch.Tensor | None = None        # (Bt, 3) f32
    top_hi: torch.Tensor | None = None        # (Bt, 3) f32
    top_skip: torch.Tensor | None = None      # (Bt,) i32
    top_cluster: torch.Tensor | None = None   # (Bt,) i32, -1 inner
    top_tri_base: torch.Tensor | None = None  # (Bt,) i32
    cl_nodes_f: torch.Tensor | None = None    # (Nc, 6, rows, 128) f32
    cl_nodes_i: torch.Tensor | None = None    # (Nc, 3, rows, 128) i32
    cl_tris: torch.Tensor | None = None       # (Nc, 9, rows, 128) f32
    # the boundary triangles of mesh-bounded media (``medium_mesh``), None
    # without: corners and the medium each belongs to
    med_tri_p0: torch.Tensor | None = None    # (K, 3) f32
    med_tri_p1: torch.Tensor | None = None    # (K, 3) f32
    med_tri_p2: torch.Tensor | None = None    # (K, 3) f32
    med_tri_mid: torch.Tensor | None = None   # (K,) i32 medium index
    # the sphere BVH (``scene/build.py``, ``srt_tpu/scene/ir.py:295-305``)
    # of a scene with at least ``SceneBuilder.sphere_bvh_min`` spheres that
    # are not environment domes, None with fewer: a skip-link tree over
    # their motion-union boxes whose leaves hold original sphere ids
    # through ``sbvh_ids`` (no sphere table is reordered), and the domes,
    # which every ray hits and the tree leaves out
    sbvh_lo: torch.Tensor | None = None       # (Bs, 3) f32
    sbvh_hi: torch.Tensor | None = None       # (Bs, 3) f32
    sbvh_skip: torch.Tensor | None = None     # (Bs,) i32
    sbvh_first: torch.Tensor | None = None    # (Bs,) i32 into sbvh_ids
    sbvh_count: torch.Tensor | None = None    # (Bs,) i32
    sbvh_ids: torch.Tensor | None = None      # (Sn,) i32 sphere ids
    sph_env_ids: torch.Tensor | None = None   # (Se,) i32 dome ids

    @property
    def n_spheres(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def n_rects(self) -> int:
        return self.rect_k.shape[0]

    @property
    def n_tris(self) -> int:
        return self.tri_p0.shape[0]

    @property
    def n_bvh_nodes(self) -> int:
        return self.bvh_skip.shape[0]

    @property
    def n_media(self) -> int:
        return self.med_kind.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sph_radius.device


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SceneFlags(NamedTuple):
    """Static facts about a scene: which texture/material families and
    light kinds it uses, its widest BVH leaf, whether any sphere moves,
    whether the JAX package's fused-bounce kernel would take it, and
    whether a medium is bounded by a mesh (read once here, so the coverage
    gate reads no device memory). ``ref_parity`` and ``parity_no_stale``
    are the render's estimator switches, False from :meth:`of`; a render
    sets them from its config (``render.api.scene_flags``), as the JAX
    package's flags carry them (``srt_tpu/scene/ir.py:89-94``): the
    reference's as-implemented estimator, and its diagnostic variant whose
    heap slot reads 0. ``sbvh_leaf`` is the sphere BVH's widest leaf (4
    without one), independent of ``bvh_leaf``: a tiny mesh can shrink the
    triangle leaf below 4, which would drop sphere hits
    (``srt_tpu/render/intersect.py:530-532``). ``sphere_bvh`` is the
    render's switch (``RenderConfig.sphere_bvh``, False from :meth:`of`):
    the plain bounce walks the sphere BVH instead of sweeping every sphere
    (``render.intersect.intersect_scene``); the bounce kernels sweep
    whatever it says, as the JAX package's fused kernels do."""
    tex_kinds: tuple
    mat_kinds: tuple
    bvh_leaf: int = 4
    sbvh_leaf: int = 4
    fused_bounce: bool = False
    light_kinds: tuple = ()
    moving: bool = False
    fused_deferred_albedo: bool = False
    mesh_media: bool = False
    ref_parity: bool = False
    parity_no_stale: bool = False
    sphere_bvh: bool = False

    @staticmethod
    def of(scene: TorchScene) -> "SceneFlags":
        tt = _np(scene.tex_type)
        mt = _np(scene.mat_type)
        scat = mt != int(MaterialType.DIFFUSE_LIGHT)
        defer = bool(np.isin(tt[_np(scene.mat_tex)][scat],
                             [int(TextureType.NOISE),
                              int(TextureType.IMAGE)]).any())
        return SceneFlags(
            tex_kinds=tuple(sorted(set(tt.tolist()))),
            mat_kinds=tuple(sorted(set(mt.tolist()))),
            bvh_leaf=int(_np(scene.bvh_count).max(initial=0)) or 4,
            sbvh_leaf=(4 if scene.sbvh_count is None else
                       int(_np(scene.sbvh_count).max(initial=0)) or 4),
            fused_bounce=_fused_bounce_eligible(scene, mt, tt),
            light_kinds=tuple(_np(scene.light_kind).tolist()),
            moving=bool((_np(scene.sph_center0)
                         != _np(scene.sph_center1)).any()),
            fused_deferred_albedo=defer,
            mesh_media=bool((_np(scene.med_kind) == 2).any()))


#: the fields of :class:`SceneFlags` that the JAX package's ``SceneFlags``
#: does not have (its gate reads ``med_kind`` where it needs it; its
#: sphere BVH is switched by the environment variable
#: ``SRT_TPU_SPHERE_BVH``, which the port does not read)
PORT_FLAGS = ("mesh_media", "sphere_bvh")


def _fused_bounce_eligible(scene: TorchScene, mat_types: np.ndarray,
                           tex_types: np.ndarray) -> bool:
    """The JAX package's gate for its fused bounce kernel
    (``srt_tpu/scene/ir.py:_fused_bounce_eligible``), on the same caps."""
    if scene.merl.shape[0]:
        return False
    if scene.n_spheres + scene.n_rects + scene.n_tris == 0:
        return False
    if scene.n_spheres > 4096 or scene.n_rects > 64 or scene.n_lights > 8:
        return False
    if scene.mat_type.shape[0] > 512:
        return False
    if scene.n_media:
        if bool((_np(scene.med_kind) == 2).any()) or scene.n_media > 8:
            return False
    allowed = {int(MaterialType.LAMBERTIAN), int(MaterialType.OREN_NAYAR),
               int(MaterialType.BECKMANN), int(MaterialType.METAL),
               int(MaterialType.DIELECTRIC), int(MaterialType.DIFFUSE_LIGHT),
               int(MaterialType.ISOTROPIC)}
    if not set(mat_types.tolist()) <= allowed:
        return False
    return bool(np.isin(tex_types,
                        [int(TextureType.CONSTANT), int(TextureType.CHECKER),
                         int(TextureType.NOISE),
                         int(TextureType.IMAGE)]).all())


_COVERED_MATS = {int(m) for m in MaterialType}
#: the one-sample specular branch (metal, dielectric, isotropic)
SPECULAR_MATS = {int(MaterialType.METAL), int(MaterialType.DIELECTRIC),
                 int(MaterialType.ISOTROPIC)}


def rich_families(scene: TorchScene, flags: SceneFlags) -> list[str]:
    """The families of this scene that only the bounce kernels' rich
    instantiation holds (``kRich`` in ``csrc/bounce_core.cuh``): the
    specular branch, the media sweep, checker and noise textures, image
    textures on scattering materials, sphere lights. Empty for a scene
    the lean instantiation shades (ball_scenes, cornell_boxes). Reads the
    flags and the table shapes only, no device memory, so a launch can
    decide on the host alone."""
    out = []
    specular = sorted(MaterialType(m).name for m in
                      set(flags.mat_kinds) & SPECULAR_MATS)
    if specular:
        out.append(f"materials {specular}")
    if scene.n_media:
        out.append("participating media")
    if set(flags.tex_kinds) & {int(TextureType.CHECKER),
                               int(TextureType.NOISE)}:
        out.append("checker and noise textures")
    if flags.fused_deferred_albedo:
        out.append("noise or image textures on scattering materials")
    if int(LightKind.SPHERE) in flags.light_kinds:
        out.append("sphere lights")
    return out


def require_covered(scene: TorchScene, flags: SceneFlags) -> None:
    """Raise ``NotImplementedError`` for a scene the port cannot render:
    one whose material type ids name no :class:`MaterialType`, which no
    bounce would shade as its builder meant. Every scene of the JAX
    package's builder renders: the families of its fused bounce kernel
    (``_kernel``, ``srt_tpu/pallas/bounce.py:1067``), packed 8-bit and
    float image atlases among them, through the bounce kernels, and what
    that kernel's gate (``_fused_bounce_eligible``) refuses -- MERL
    measured BRDFs, mesh-bounded media, scenes past its table caps --
    through the plain bounce, as the JAX package sends them to its XLA
    bounce. Reads the flags, no device memory: the train step runs it
    before every backward launch."""
    unknown = sorted(set(flags.mat_kinds) - _COVERED_MATS)
    if unknown:
        raise NotImplementedError(
            f"srt_tpu_torch has no material of type ids {unknown}")


def require_trainable(scene: TorchScene, flags: SceneFlags) -> None:
    """Raise ``NotImplementedError`` for a scene the train step cannot
    differentiate: exactly what :func:`require_covered` refuses. The train
    step never sets the parity flags, as JAX's ``make_train_step`` never
    does. Every family the render kernels shade, the train step
    differentiates: kernel B5 (its lean or rich instantiation) under
    frozen geometry, the hybrid backward on triangles, moving spheres,
    geometric parameters and an optimised image atlas, and autograd of
    the plain bounce where the bounce kernel's gate refuses the scene
    (MERL among them)."""
    require_covered(scene, flags)
