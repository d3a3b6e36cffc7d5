"""The work a kernel's inputs need, and the least time an H100 could take
for it: the arithmetic behind every ``*_roofline`` metric.

Copied from ``chip_smoke.py`` (``bound``, ``PEAK_*``, ``OPS_*``,
``VJP_SHADE``): operations are counted from
``srt_tpu_torch/csrc/bounce_core.cuh``, an arithmetic or transcendental
operation one, and bytes from each kernel's arguments, an input byte once
a launch and an output byte once. The counts depend on the inputs only
(the scene, the lanes that are live), never on how a kernel does the
work, so they read the same whatever implements it. Where a count cannot
be read exactly it is taken low, so a share never reads above what the
kernel achieved: shading is counted on ``vertices - rays`` lanes (a path
of ``n`` vertices scatters at least ``n - 1`` times), at the cheapest
family the scene holds, and each pixel is touched once by the film.
"""
from __future__ import annotations

import numpy as np

#: H100 SXM at 700 W (NVIDIA's data sheet): float32 outside the tensor
#: cores, and HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
#: a sphere test of the sweep, with the motion lerp on a moving scene; a
#: rect test
OPS_SPHERE = 21
OPS_SPHERE_MOVING = 28
OPS_RECT = 10
#: a diffuse-branch lane's shading (Beckmann VNDF, light sample, pdfs),
#: and a specular-branch lane's (reflection, fuzz ball or Schlick)
OPS_SHADE = 600
OPS_SPECULAR = 120
#: the backward of a shading: the forward replayed, then its reverse sweep
#: at about twice the forward
VJP_SHADE = 3
#: bytes a lane of B1 reads and writes (state planes, depth, alive,
#: finished), a live lane's state writes, a regenerated lane's
B1_LANE_BYTES = 68 + 12
B1_LIVE_BYTES = 48
B1_NEW_BYTES = 12
#: bytes a lane of B2 reads and writes; of B5
B2_LANE_BYTES = 57 + 53
B5_LANE_BYTES = 105 + 92
#: the film: a lane's two planes, a finished lane's pixel and radiance, a
#: pixel's sum read and written, the launch's counters
FILM_LANE_BYTES = 8
FILM_FIN_BYTES = 4 + 12
FILM_PIXEL_BYTES = 24
FILM_LAUNCH_BYTES = 16

_DIFFUSE_MATS = {0, 1, 2}       # Lambertian, Oren–Nayar, Beckmann
_SPECULAR_MATS = {3, 4, 6}      # metal, dielectric, isotropic


def least_seconds(n_bytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger, and which."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / PEAK_F32
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sweep_ops(arrays: dict) -> int:
    """Operations of one lane's closest-hit sweep over the scene."""
    moving = bool((arrays["sph_center0"] != arrays["sph_center1"]).any())
    n_sph = arrays["sph_radius"].shape[0]
    return (n_sph * (OPS_SPHERE_MOVING if moving else OPS_SPHERE)
            + arrays["rect_k"].shape[0] * OPS_RECT)


def shade_ops(arrays: dict) -> int:
    """Operations of the cheapest shading a scattering lane of this scene
    can take."""
    kinds = set(np.asarray(arrays["mat_type"]).tolist())
    costs = ([OPS_SHADE] if kinds & _DIFFUSE_MATS else []) + (
        [OPS_SPECULAR] if kinds & _SPECULAR_MATS else [])
    return min(costs) if costs else 0


def b1(arrays: dict, *, launches: int, lanes: int, vertices: int,
       rays: int) -> tuple[float, str]:
    """B1 over a render: ``launches`` of a ``lanes``-lane wavefront that
    traced ``vertices`` path vertices from ``rays`` camera rays."""
    n_bytes = (launches * lanes * B1_LANE_BYTES + vertices * B1_LIVE_BYTES
               + rays * B1_NEW_BYTES)
    ops = vertices * sweep_ops(arrays) + (vertices - rays) * shade_ops(arrays)
    return least_seconds(n_bytes, ops)


def film(*, launches: int, lanes: int, rays: int,
         pixels: int) -> tuple[float, str]:
    """The film over a render: every lane's planes a launch, each camera
    ray's radiance once as it finishes, each pixel's sum once."""
    n_bytes = (launches * (lanes * FILM_LANE_BYTES + FILM_LAUNCH_BYTES)
               + rays * FILM_FIN_BYTES + pixels * FILM_PIXEL_BYTES)
    return least_seconds(n_bytes, 3 * rays)


def b2(arrays: dict, *, vertices: int, rays: int) -> tuple[float, str]:
    """B2 over a render: its live lanes only (``vertices`` over every
    launch, from ``rays`` camera rays)."""
    ops = vertices * sweep_ops(arrays) + (vertices - rays) * shade_ops(arrays)
    return least_seconds(vertices * B2_LANE_BYTES, ops)


def b5(arrays: dict, *, vertices: int, rays: int) -> tuple[float, str]:
    """B5 over a train step's backward: its live lanes, the sweep once and
    the shading's VJP."""
    ops = (vertices * sweep_ops(arrays)
           + (vertices - rays) * VJP_SHADE * shade_ops(arrays))
    return least_seconds(vertices * B5_LANE_BYTES, ops)
