"""The thin-lens camera with its shutter interval: ``look_at``, which the
scene generators use to make the camera's arrays, and the primary rays.

A frozen copy of ``srt_tpu_torch/render/camera.py`` (reference
``camera.h:16-71``). ``look_at`` runs in float32 torch on the CPU, as the
program's library builds its cameras, so the arrays are the library's to
the bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.core import cross, normalize

_F32 = torch.float32


class Camera(NamedTuple):
    origin: torch.Tensor        # (3,)
    lower_left: torch.Tensor    # (3,)
    horizontal: torch.Tensor    # (3,)
    vertical: torch.Tensor      # (3,)
    u: torch.Tensor             # (3,) right
    v: torch.Tensor             # (3,) up
    lens_radius: torch.Tensor   # ()
    time0: torch.Tensor         # ()
    time1: torch.Tensor         # ()

    @staticmethod
    def look_at(lookfrom, lookat, vup=(0.0, 1.0, 0.0), vfov=40.0,
                aspect=1.0, aperture=0.0, focus_dist=10.0,
                time0=0.0, time1=1.0, device="cpu") -> "Camera":
        def t(x):
            return torch.as_tensor(x, dtype=_F32, device=device)

        lookfrom, lookat, vup = t(lookfrom), t(lookat), t(vup)
        theta = vfov * math.pi / 180.0
        half_height = torch.tan(t(theta / 2.0))
        half_width = aspect * half_height
        w = normalize(lookfrom - lookat)
        u = normalize(cross(vup, w))
        v = cross(w, u)
        lower_left = (lookfrom - half_width * focus_dist * u
                      - half_height * focus_dist * v - focus_dist * w)
        return Camera(origin=lookfrom, lower_left=lower_left,
                      horizontal=2.0 * half_width * focus_dist * u,
                      vertical=2.0 * half_height * focus_dist * v,
                      u=u, v=v, lens_radius=t(aperture / 2.0),
                      time0=t(time0), time1=t(time1))

    def rays(self, s, t, u_lens1, u_lens2, u_time):
        """Primary rays ``(origin, direction, time)`` for film coords
        (s, t) in [0,1]^2 (``camera.h:51-59``); lens disk r = R*sqrt(u)."""
        r = self.lens_radius * torch.sqrt(u_lens1)
        phi = 2.0 * math.pi * u_lens2
        offset = (self.u * (r * torch.cos(phi))[..., None]
                  + self.v * (r * torch.sin(phi))[..., None])
        time = self.time0 + u_time * (self.time1 - self.time0)
        origin = self.origin + offset
        direction = normalize(self.lower_left + s[..., None] * self.horizontal
                              + t[..., None] * self.vertical
                              - self.origin - offset)
        return origin, direction, time


def camera_arrays(camera: Camera) -> dict:
    """The camera's fields as float32 numpy arrays (the form
    ``srt_tpu_torch.convert.camera_from_arrays`` takes)."""
    return {k: np.asarray(getattr(camera, k).cpu().numpy(), np.float32)
            for k in Camera._fields}


def camera_from(arrays: dict, device) -> Camera:
    """A :class:`Camera` on ``device`` from :func:`camera_arrays`."""
    return Camera(**{k: torch.as_tensor(np.asarray(arrays[k], np.float32),
                                        device=device)
                     for k in Camera._fields})
