"""Tables carried across from the JAX package, through numpy.

The JAX package stays the reference: a test builds a scene with
``srt_tpu.scene.library``, turns each field into a numpy array and hands
the dict here, so both packages render from identical tables. This module
itself imports neither JAX nor ``srt_tpu``. Every function puts its
tensors on the card unless the caller passes another ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from srt_tpu_torch.render.camera import Camera
from srt_tpu_torch.scene.ir import TorchScene


def scene_from_arrays(d: dict[str, np.ndarray], device="cuda") -> TorchScene:
    """``TorchScene`` from the JAX ``Scene`` fields after ``np.asarray``
    (extra fields are ignored), the MERL tables and a float atlas among
    them; ``atlas_u32`` is None where JAX's scene has no packed twin."""
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
