"""MERL measured-BRDF table lookup in Rusinkiewicz half/diff coordinates
(counterpart of ``srt_tpu/materials/merl.py``).

The math of the reference's ``brdf.h:106-214``
(``std_coords_to_half_diff_coords`` and the index quantization) over
batches of local-frame directions: the square-root warp on theta_half,
``phi_d < 0`` folded by pi (reciprocity), every index clamped to its
range. The float-to-int conversions truncate toward zero, as the JAX
package's ``astype(int32)`` does. An angle within rounding of a bin edge
may land in the neighbouring bin on another backend
(``utils/contract.py:MERL_INDEX_MISMATCH``). The binary reader lives in
:mod:`srt_tpu_torch.io.merl`.
"""
from __future__ import annotations

import math

import torch

from srt_tpu_torch.io.merl import RES_PHI_D, RES_THETA_D, RES_THETA_H


def _rotate_z(v, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1], v[..., 2]], -1)


def _rotate_y(v, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([c * v[..., 0] + s * v[..., 2], v[..., 1],
                        -s * v[..., 0] + c * v[..., 2]], -1)


def half_diff_indices(wo, wi):
    """Quantized (theta_half, theta_diff, phi_diff) table index (N,) int32
    of local directions ``wo``, ``wi`` (N, 3): the index quantization of
    ``brdf.h:17-61``."""
    wh = wo + wi
    wh = wh / torch.clamp(torch.linalg.vector_norm(wh, dim=-1, keepdim=True),
                          min=1e-20)
    theta_h = torch.arccos(torch.clamp(wh[..., 2], -1.0, 1.0))
    phi_h = torch.atan2(wh[..., 1], wh[..., 0])

    d = _rotate_y(_rotate_z(wi, -phi_h), -theta_h)
    theta_d = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi_d = torch.atan2(d[..., 1], d[..., 0])

    th_deg = theta_h / (math.pi / 2.0) * RES_THETA_H
    th_idx = torch.sqrt(torch.clamp(th_deg * RES_THETA_H, min=0.0)).to(
        torch.int32)
    th_idx = torch.clamp(th_idx, 0, RES_THETA_H - 1)

    td_idx = torch.clamp((theta_d / (math.pi / 2.0) * RES_THETA_D).to(
        torch.int32), 0, RES_THETA_D - 1)

    phi_d = torch.where(phi_d < 0.0, phi_d + math.pi, phi_d)
    pd_idx = torch.clamp((phi_d / math.pi * (RES_PHI_D // 2)).to(
        torch.int32), 0, RES_PHI_D // 2 - 1)

    return (pd_idx + td_idx * (RES_PHI_D // 2)
            + th_idx * (RES_PHI_D // 2) * RES_THETA_D)


def lookup(tables, table_id, wo, wi):
    """f_rgb(wo, wi) (N, 3) from the stacked tables (Nm, 3, K), scales
    already applied; ``table_id`` (N,) picks each lane's table."""
    ind = half_diff_indices(wo, wi).long()
    tid = torch.clamp(table_id.long(), 0, tables.shape[0] - 1)
    k = tables.shape[-1]
    flat = tables.reshape(-1)
    base = (tid * 3) * k + torch.clamp(ind, 0, k - 1)
    val = torch.stack([flat[base], flat[base + k], flat[base + 2 * k]], -1)
    return torch.clamp(val, min=0.0)
