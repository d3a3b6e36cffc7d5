"""Procedural Utah teapot: Bézier-patch tessellation into a triangle soup
(a copy of ``srt_tpu/scene/teapot.py:45-111``).

The reference's ``teapot.h:10-172``: 32 bicubic Bézier patches over
Newell's public-domain control points (``teapot_data.npz`` holds the same
32x16 patch indices and 306 vertices the reference vendors in
``teapotdata.h``). The tessellation runs in float64 and drops zero-area
triangles, so the triangle count and order equal the JAX package's bit for
bit (at ``divs=100``: 640k triangles a teapot).
"""
from __future__ import annotations

import os

import numpy as np

from srt_tpu_torch.io.mesh import TriMesh

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "teapot_data.npz")


def _bernstein(t: np.ndarray) -> np.ndarray:
    """Cubic Bernstein basis: (n,) -> (n, 4)."""
    t = np.asarray(t, np.float64)
    u = 1.0 - t
    return np.stack([u ** 3, 3 * t * u ** 2, 3 * t ** 2 * u, t ** 3], axis=-1)


def _bernstein_d(t: np.ndarray) -> np.ndarray:
    """Cubic Bernstein derivative basis: (n,) -> (n, 4)."""
    t = np.asarray(t, np.float64)
    u = 1.0 - t
    return np.stack([-3 * u ** 2, 3 * u ** 2 - 6 * t * u,
                     6 * t * u - 3 * t ** 2, 3 * t ** 2], axis=-1)


def create_teapot(scale: float = 1.0, divs: int = 100,
                  smooth: bool = False) -> TriMesh:
    """Tessellate the teapot into a :class:`TriMesh` with (u, v) texture
    coordinates. Each (divs x divs) quad (v0, v1, v2, v3) emits (v0, v1,
    v2) and (v0, v2, v3), as ``teapot.h:88-135``. ``smooth`` adds the
    patches' analytic normals (the reference shades flat)."""
    data = np.load(_DATA)
    patches = data["patches"]          # (32, 16) 1-based vertex indices
    cps = data["vertices"]             # (306, 3)
    cp = cps[patches - 1].reshape(32, 4, 4, 3).astype(np.float64)  # [v][u]

    t = np.linspace(0.0, 1.0, divs + 1)
    bu = _bernstein(t)                 # (G, 4)
    bv = _bernstein(t)
    # P[p, j(v), i(u)] = sum_{a,b} bv[j,a] * bu[i,b] * cp[p, a, b]
    grid = np.einsum("ja,ib,pabc->pjic", bv, bu, cp)   # (32, G, G, 3)

    if smooth:
        du = np.einsum("ja,ib,pabc->pjic", bv, _bernstein_d(t), cp)
        dv = np.einsum("ja,ib,pabc->pjic", _bernstein_d(t), bu, cp)
        nrm = np.cross(du, dv)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        # collapsed control points (the lid tip): zero here, replaced by
        # the triangle's geometric normal below
        nrm = np.where(ln > 1e-9, nrm / np.maximum(ln, 1e-9), 0.0)
    else:
        nrm = None

    g = divs + 1
    j, i = np.meshgrid(np.arange(divs), np.arange(divs), indexing="ij")
    v0 = (j * g + i).reshape(-1)
    v1 = (j * g + i + 1).reshape(-1)
    v2 = ((j + 1) * g + i + 1).reshape(-1)
    v3 = ((j + 1) * g + i).reshape(-1)
    tri_idx = np.concatenate(
        [np.stack([v0, v1, v2], -1), np.stack([v0, v2, v3], -1)])  # (2dd, 3)

    flat = grid.reshape(32, g * g, 3)
    pos = flat[:, tri_idx].reshape(-1, 3, 3) * scale

    uu, vv = np.meshgrid(t, t, indexing="xy")
    uvflat = np.stack([uu, vv], -1).reshape(g * g, 2)
    uv = np.broadcast_to(uvflat[tri_idx], (32,) + tri_idx.shape + (2,))
    uv = uv.reshape(-1, 3, 2)

    if nrm is not None:
        nflat = nrm.reshape(32, g * g, 3)
        n = nflat[:, tri_idx].reshape(-1, 3, 3)
        gn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
        gn = gn / np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
        bad = np.linalg.norm(n, axis=-1) < 0.5
        n = np.where(bad[..., None], gn[:, None, :], n)
    else:
        n = None

    # drop the zero-area triangles of collapsed patch edges (the reference
    # keeps them; they cost BVH nodes and can give det = 0 rays)
    area2 = np.linalg.norm(
        np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]), axis=1)
    keep = area2 > 1e-12 * max(scale, 1.0) ** 2
    return TriMesh(
        np.ascontiguousarray(pos[keep], np.float32),
        np.ascontiguousarray(uv[keep], np.float32),
        None if n is None else np.ascontiguousarray(n[keep], np.float32))
