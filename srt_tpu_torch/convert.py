"""Scenes, cameras and parameters from numpy arrays.

The JAX package stays the reference: a test builds a scene with
``srt_tpu.scene.library``, turns each field into a numpy array and hands
the dict here, so both packages render from identical tables. A scene
given as its primitives alone, its triangles a soup with no acceleration
tables (the benchmark's scene generators give such arrays), gets the
tables ``SceneBuilder`` derives (:func:`scene.build.triangle_tables`).
This module itself imports neither JAX nor ``srt_tpu``. Every function
puts its tensors on the card unless the caller passes another
``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from srt_tpu_torch.render.camera import Camera
from srt_tpu_torch.scene.build import triangle_tables
from srt_tpu_torch.scene.ir import TorchScene


def scene_from_arrays(d: dict[str, np.ndarray], device="cuda") -> TorchScene:
    """``TorchScene`` from a dict of its fields as numpy arrays (extra
    fields are ignored): the JAX ``Scene``'s after ``np.asarray``, the
    MERL tables and a float atlas among them, or ``SceneBuilder``'s;
    ``atlas_u32`` is None where the scene has no packed twin. Where the
    triangle fields hold rows and ``bvh_lo`` is absent, the triangles are
    a soup in the order they were added: they are put in BVH order and
    the BVH and its clusters derived from them as ``SceneBuilder.build``
    derives them (:func:`triangle_tables`), so the scene is the one
    ``SceneBuilder.build`` gives, bit for bit. Any other dict is copied
    field by field."""
    tri_p0 = d.get("tri_p0")
    if tri_p0 is not None and len(tri_p0) and d.get("bvh_lo") is None:
        p = np.stack([np.asarray(d[k], np.float32)
                      for k in ("tri_p0", "tri_p1", "tri_p2")], 1)
        d = dict(d, **triangle_tables(
            p, np.asarray(d["tri_uv"], np.float32),
            np.asarray(d["tri_n"], np.float32),
            np.asarray(d["tri_mat"], np.int32)))
    out = {}
    for f in dataclasses.fields(TorchScene):
        v = d.get(f.name)
        out[f.name] = (None if v is None else
                       torch.from_numpy(np.array(v, order="C")).to(device))
    return TorchScene(**out)


def camera_from_arrays(d: dict[str, np.ndarray], device="cuda") -> Camera:
    """``Camera`` from the JAX ``Camera`` fields after ``np.asarray``."""
    return Camera(**{k: torch.as_tensor(np.asarray(d[k], np.float32),
                                        device=device)
                     for k in Camera._fields})


def params_from_arrays(d: dict[str, np.ndarray],
                       device="cuda") -> dict[str, torch.Tensor]:
    """Optimised parameters (e.g. ``{"tex_color": ...}`` or
    ``{"atlas": ...}``) as float32 tensors, so the port starts from the
    JAX package's numbers."""
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            .to(device) for k, v in d.items()}
