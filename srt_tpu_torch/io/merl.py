"""MERL measured-BRDF binary reader (counterpart of ``srt_tpu/io/merl.py``,
a numpy-only copy; format of the reference's ``brdf.h:156-188``).

File layout: three little-endian int32 dims (90, 90, 180), then
``3 * 90*90*180`` float64 values, one full plane per colour channel in
R, G, B order. The per-channel scales {1/1500, 1.15/1500, 1.66/1500}
(``brdf.h:12-14``) are applied here, so the table on the device is a plain
float32 gather (:mod:`srt_tpu_torch.materials.merl` does the Rusinkiewicz
indexing). No ``.binary`` asset ships with the repository: the tests write
a synthetic table with :func:`write_merl` and read it back.
"""
from __future__ import annotations

import numpy as np

RES_THETA_H = 90
RES_THETA_D = 90
RES_PHI_D = 360  # stored /2 due to reciprocity

#: Per-channel de-quantization scales (brdf.h:12-14).
CHANNEL_SCALES = (1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0)


def read_merl(path: str) -> np.ndarray:
    """Read a MERL .binary table -> (3, 90*90*180) float32, scales applied."""
    with open(path, "rb") as f:
        dims = np.fromfile(f, np.int32, 3)
        n = int(dims[0]) * int(dims[1]) * int(dims[2])
        expected = RES_THETA_H * RES_THETA_D * RES_PHI_D // 2
        if n != expected:
            raise ValueError(
                f"{path}: dims {tuple(dims)} don't match the MERL grid "
                f"(expected {expected} samples, got {n})")
        data = np.fromfile(f, np.float64, 3 * n)
    if data.size != 3 * n:
        raise ValueError(f"{path}: truncated table")
    table = data.reshape(3, n)
    scales = np.asarray(CHANNEL_SCALES, np.float64)[:, None]
    return (table * scales).astype(np.float32)


def write_merl(path: str, table_rgb: np.ndarray) -> None:
    """Write a (3, N) *unscaled* float table in MERL layout (for tests)."""
    n = table_rgb.shape[1]
    dims = np.asarray([RES_THETA_H, RES_THETA_D, RES_PHI_D // 2], np.int32)
    assert n == RES_THETA_H * RES_THETA_D * RES_PHI_D // 2, n
    with open(path, "wb") as f:
        dims.tofile(f)
        np.asarray(table_rgb, np.float64).reshape(-1).tofile(f)
