"""Triangle soups (counterpart of ``srt_tpu/io/mesh.py:33-62``).

Only :class:`TriMesh` and its instancing transform: the mesh loaders wait
for their assets (ROADMAP A8). A soup holds per-corner attributes, as the
reference's ``geometry.h:61-77`` expands them at load.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TriMesh(NamedTuple):
    """Triangle soup; per-corner attributes (may be None)."""
    positions: np.ndarray          # (T, 3, 3) float32
    uvs: np.ndarray | None         # (T, 3, 2) float32 or None
    normals: np.ndarray | None     # (T, 3, 3) float32 or None

    @property
    def n_tris(self) -> int:
        return len(self.positions)

    def transformed(self, scale=(1.0, 1.0, 1.0), rotate=None,
                    translate=(0.0, 0.0, 0.0), flip_winding=False,
                    flip_uvs=False) -> "TriMesh":
        """Bake scale -> rotate -> translate (the reference's
        ``translate(rotate_y(bvh_node(model)))`` wrapping with load-time
        scale, ``geometry.h:67`` + ``Raytracing_n.cpp:642``)."""
        p = self.positions * np.asarray(scale, np.float32)
        if rotate is not None:
            p = p @ np.asarray(rotate, np.float32).T
        p = p + np.asarray(translate, np.float32)
        n = self.normals
        if n is not None and rotate is not None:
            n = n @ np.asarray(rotate, np.float32).T
        uv = self.uvs
        if flip_uvs and uv is not None:
            uv = np.stack([uv[..., 0], 1.0 - uv[..., 1]], axis=-1)
        if flip_winding:
            p = p[:, ::-1]
            n = None if n is None else n[:, ::-1]
            uv = None if uv is None else uv[:, ::-1]
        return TriMesh(
            np.ascontiguousarray(p, np.float32),
            None if uv is None else np.ascontiguousarray(uv, np.float32),
            None if n is None else np.ascontiguousarray(n, np.float32))
