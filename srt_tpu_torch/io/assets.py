"""Asset resolution (counterpart of ``srt_tpu/io/assets.py``).

Assets are looked up by content-relative path under ``$SRT_ASSETS`` and
the repository's ``assets/`` folder. A missing image degrades to a small
constant-color stand-in with a warning, so every scene still builds.
"""
from __future__ import annotations

import os
import warnings

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def asset_roots() -> list[str]:
    return [os.environ.get("SRT_ASSETS", ""),
            os.path.join(_REPO_ROOT, "assets")]


def find_asset(rel_path: str) -> str | None:
    """Resolve a content-relative path (e.g. ``environment_map/sky_2.png``)."""
    rel = rel_path.replace("\\", "/")
    for root in asset_roots():
        if root and os.path.isfile(os.path.join(root, rel)):
            return os.path.join(root, rel)
    return None


def require_asset(rel_path: str) -> str:
    """The path of an asset, as :func:`find_asset` resolves it; a missing
    one raises ``FileNotFoundError`` naming the roots searched
    (``srt_tpu/io/assets.py:40-46``)."""
    path = find_asset(rel_path)
    if path is None:
        raise FileNotFoundError(
            f"asset {rel_path!r} not found under any of {asset_roots()}; "
            f"set SRT_ASSETS to a contents/ tree")
    return path


def load_image_asset(rel_path: str, fallback_color=(0.5, 0.5, 0.5),
                     fallback_size: int = 8) -> np.ndarray:
    """Decode an image asset to (ny, nx, 3) uint8, or the stand-in."""
    from srt_tpu_torch.io.image import load_image
    path = find_asset(rel_path)
    if path is None:
        warnings.warn(f"asset {rel_path!r} missing; using constant stand-in")
        c = (np.asarray(fallback_color, np.float32) * 255).astype(np.uint8)
        return np.broadcast_to(c, (fallback_size, fallback_size, 3)).copy()
    return load_image(path)
