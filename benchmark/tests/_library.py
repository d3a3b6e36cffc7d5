"""The port's library scenes as the arrays the plain reference reads, for
the tests that hold the reference to the port on triangle scenes: until
the port derives its BVH from a soup, such a scene comes from the port's
own builder."""
from __future__ import annotations

import dataclasses
import warnings

from srt_tpu_torch import get_scene
from srt_tpu_torch.scene.ir import TorchScene


def library_arrays(name: str, **kw) -> tuple[dict, dict]:
    """A scene of the port's library as the arrays the reference reads,
    BVH order and all, and its camera's arrays."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene(name, device="cpu", **kw)
    arrays = {f.name: getattr(scene, f.name).numpy()
              for f in dataclasses.fields(TorchScene)
              if getattr(scene, f.name) is not None}
    return arrays, {k: getattr(cam, k).numpy() for k in cam._fields}
