"""Structured render metrics (counterpart of ``srt_tpu/utils/metrics.py``):
throughput (primary rays, path vertices traced, wall seconds, rates), the
scan engine's bounce histogram, the NaN-scrub count (``de_nan``,
``Raytracing_n.cpp:47-53``, counted instead of silent), and the route the
render took: its bounce (``"B1"``, ``"B2"`` or ``"plain"``) and its
triangle walk (``"B3"``, ``"B4"``, ``"plain"`` or None)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RenderMetrics:
    width: int = 0
    height: int = 0
    spp: int = 0
    max_depth: int = 0
    primary_rays: int = 0
    path_vertices: int = 0          # ray segments traced (sum of alive lanes)
    nan_scrubbed: int = 0           # radiance channels zeroed by de_nan
    bounces: int = 0                # wavefront steps of the route
    wall_s: float = 0.0
    alive_per_bounce: np.ndarray | None = None  # (max_depth,) lanes entering
                                                # each bounce (scan engine)
    bounce: str = ""
    walk: str | None = None

    @property
    def primary_rays_per_sec(self) -> float:
        return self.primary_rays / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def vertices_per_sec(self) -> float:
        return self.path_vertices / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_path_length(self) -> float:
        return (self.path_vertices / self.primary_rays
                if self.primary_rays else 0.0)

    def to_dict(self) -> dict:
        d = {
            "width": self.width, "height": self.height, "spp": self.spp,
            "max_depth": self.max_depth,
            "primary_rays": self.primary_rays,
            "path_vertices": self.path_vertices,
            "mean_path_length": round(self.mean_path_length, 3),
            "nan_scrubbed": self.nan_scrubbed,
            "bounces": self.bounces,
            "wall_s": round(self.wall_s, 3),
            "primary_rays_per_sec": round(self.primary_rays_per_sec, 1),
            "vertices_per_sec": round(self.vertices_per_sec, 1),
            "bounce": self.bounce, "walk": self.walk,
        }
        if self.alive_per_bounce is not None:
            d["alive_per_bounce"] = self.alive_per_bounce.tolist()
        return d
