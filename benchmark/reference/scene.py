"""The plain reference's scene: the input arrays the benchmark makes
(``benchmark/scenes/<config>.py``), as tensors on one device, and the
static facts the shading reads.

The program gets the same arrays and derives its own tables from them
(packed sphere records, the material table, the packed rgb8 atlas, the
triangles' BVH and clusters); the reference derives nothing of them and
reads the arrays as they are: the float atlas, never its packed twin; the
triangle soup, never a BVH. The ids are those of
``srt_tpu_torch/scene/ir.py`` (the reference C++ renderer's families).
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import media
from benchmark.reference.triangles import Soup


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


#: the one-sample specular branch (metal, dielectric, isotropic)
SPECULAR_MATS = {int(MaterialType.METAL), int(MaterialType.DIELECTRIC),
                 int(MaterialType.ISOTROPIC)}

#: the families the reference shades; a scene with another is refused
COVERED_MATS = {int(MaterialType.LAMBERTIAN), int(MaterialType.OREN_NAYAR),
                int(MaterialType.BECKMANN), int(MaterialType.METAL),
                int(MaterialType.DIELECTRIC),
                int(MaterialType.DIFFUSE_LIGHT), int(MaterialType.ISOTROPIC)}
COVERED_TEX = {int(TextureType.CONSTANT), int(TextureType.CHECKER),
               int(TextureType.IMAGE)}

#: the array fields the reference reads
FIELDS = ("sph_center0", "sph_center1", "sph_times", "sph_radius", "sph_mat",
          "sph_flip", "sph_env", "rect_axis", "rect_bounds", "rect_k",
          "rect_mat", "rect_flip", "mat_type", "mat_tex", "mat_params",
          "tex_type", "tex_color", "tex_color2", "tex_img", "atlas",
          "light_kind", "light_index", "tri_p0", "tri_p1", "tri_p2",
          "tri_uv", "tri_n", "tri_mat", "med_kind", "med_center",
          "med_radius", "med_half", "med_density", "med_mat")


class Flags(NamedTuple):
    """Which material and texture families the scene holds: the shading
    evaluates only those, as the program's ``SceneFlags`` says."""
    mat_kinds: tuple
    tex_kinds: tuple


class Scene:
    """The scene arrays as tensors on ``device``. ``tex_color`` may be
    replaced by a tensor that requires a gradient (the train step's
    parameter)."""

    atlas_u32 = None      # the reference reads the float atlas

    def __init__(self, arrays: dict, device):
        mats = set(np.asarray(arrays["mat_type"]).tolist())
        texs = set(np.asarray(arrays["tex_type"]).tolist())
        #: each medium's boundary kind, read on the host
        self.med_kinds = np.asarray(arrays["med_kind"]).tolist()
        if media.MESH in self.med_kinds:
            raise NotImplementedError("a medium bounded by a mesh: not in "
                                      "the reference")
        if not mats <= COVERED_MATS or not texs <= COVERED_TEX:
            raise NotImplementedError(f"materials {sorted(mats)}, textures "
                                      f"{sorted(texs)}: not in the reference")
        for k in FIELDS:
            setattr(self, k, torch.from_numpy(
                np.ascontiguousarray(arrays[k])).to(device))
        self.flags = Flags(mat_kinds=tuple(sorted(mats)),
                           tex_kinds=tuple(sorted(texs)))
        self.soup = (Soup(self.tri_p0, self.tri_p1, self.tri_p2, self.tri_uv,
                          self.tri_n, self.tri_mat)
                     if self.n_tris else None)

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
    def n_media(self) -> int:
        return len(self.med_kinds)

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sph_radius.device
