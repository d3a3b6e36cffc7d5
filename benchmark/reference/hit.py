"""The hit record every family's intersection returns, and the merge that
keeps the nearer of two (a frozen copy of ``Hit`` in
``srt_tpu_torch/render/intersect.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 3.0e38
T_POS_MAX = 1.0e7    # position-eval clamp: o + BIG*d would overflow


class Hit(NamedTuple):
    t: torch.Tensor        # (N,) BIG when miss
    hit: torch.Tensor      # (N,) bool
    p: torch.Tensor        # (N, 3)
    normal: torch.Tensor   # (N, 3) stored normal (may be flipped)
    uv: torch.Tensor       # (N, 2)
    mat: torch.Tensor      # (N,) int64 material id (0 when miss)

    @staticmethod
    def none(n: int, device) -> "Hit":
        z = torch.zeros((n, 3), dtype=torch.float32, device=device)
        return Hit(t=torch.full((n,), BIG, device=device),
                   hit=torch.zeros((n,), dtype=torch.bool, device=device),
                   p=z, normal=z, uv=z[:, :2],
                   mat=torch.zeros((n,), dtype=torch.int64, device=device))

    def closer_of(self, other: "Hit") -> "Hit":
        """``other`` where it hits strictly nearer, else ``self``: an
        earlier family wins ties."""
        take = other.hit & (other.t < self.t)
        t3 = take[:, None]
        return Hit(t=torch.where(take, other.t, self.t),
                   hit=self.hit | other.hit,
                   p=torch.where(t3, other.p, self.p),
                   normal=torch.where(t3, other.normal, self.normal),
                   uv=torch.where(t3, other.uv, self.uv),
                   mat=torch.where(take, other.mat, self.mat))


def ray_at(o, d, t):
    return o + torch.clamp(t, max=T_POS_MAX)[:, None] * d
