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
    tex_color2: torch.Tensor    # (Tx, 3) f32
    tex_img: torch.Tensor       # (Tx, 3) i32 (atlas offset, nx, ny)
    atlas: torch.Tensor         # (A,) f32
    merl: torch.Tensor          # (Nm, 3, n) f32; the gate reads its length
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
    light kinds it uses, its widest BVH leaf, whether any sphere moves, and
    whether the JAX package's fused-bounce kernel would take it."""
    tex_kinds: tuple
    mat_kinds: tuple
    bvh_leaf: int = 4
    fused_bounce: bool = False
    light_kinds: tuple = ()
    moving: bool = False
    fused_deferred_albedo: bool = False

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
            fused_bounce=_fused_bounce_eligible(scene, mt, tt),
            light_kinds=tuple(_np(scene.light_kind).tolist()),
            moving=bool((_np(scene.sph_center0)
                         != _np(scene.sph_center1)).any()),
            fused_deferred_albedo=defer)


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


_COVERED_MATS = {int(MaterialType.LAMBERTIAN), int(MaterialType.OREN_NAYAR),
                 int(MaterialType.BECKMANN), int(MaterialType.DIFFUSE_LIGHT)}
#: what the bounce covers on scenes with triangles only (B2's external-hit
#: mode holds the specular branch and the media sweep; B1 does not yet)
SPECULAR_MATS = {int(MaterialType.METAL), int(MaterialType.DIELECTRIC),
                 int(MaterialType.ISOTROPIC)}
_COVERED_TEX = {int(TextureType.CONSTANT), int(TextureType.IMAGE)}


def require_covered(scene: TorchScene, flags: SceneFlags,
                    ref_parity: bool = False) -> None:
    """Raise ``NotImplementedError`` for a scene outside the port's slice,
    naming the ROADMAP item that will port what it needs. Metal,
    dielectric, isotropic materials and sphere or box media are covered on
    scenes with triangles, whose bounce is kernel B2; a triangle-free
    scene takes kernel B1, which does not hold them yet."""
    def missing(what: str, item: str):
        raise NotImplementedError(
            f"srt_tpu_torch does not cover {what} yet (ROADMAP {item})")

    covered = set(_COVERED_MATS)
    if scene.n_tris:
        covered |= SPECULAR_MATS
        if bool((scene.med_kind == 2).any()):
            missing("mesh-bounded participating media", "A7")
    elif scene.n_media:
        missing("participating media without triangles (kernel B1)", "A7")
    if flags.moving:
        missing("moving spheres", "A7")
    if ref_parity:
        missing("the reference-parity estimator", "A9")
    if scene.merl.shape[0]:
        missing("MERL measured BRDFs", "A12")
    if not set(flags.mat_kinds) <= covered:
        names = sorted(MaterialType(m).name for m in
                       set(flags.mat_kinds) - covered)
        missing(f"materials {names}" + ("" if scene.n_tris else
                                        " without triangles (kernel B1)"),
                "A7")
    if not set(flags.tex_kinds) <= _COVERED_TEX:
        missing("checker and noise textures", "A7")
    if flags.fused_deferred_albedo:
        missing("image textures on scattering materials", "A7")
    if any(k != int(LightKind.RECT) for k in flags.light_kinds):
        missing("sphere lights", "A7")
    if scene.atlas.shape[0] and scene.atlas_u32 is None:
        missing("image atlases that are not 8-bit", "A7")
    if not flags.fused_bounce:
        missing("scenes beyond the bounce kernel's table caps", "A7")
