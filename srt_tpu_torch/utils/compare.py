"""Golden-image comparison: PSNR against a checked-in 8-bit render
(counterpart of ``srt_tpu/utils/compare.py:19-67``). Compared on the
tonemapped 8-bit scale, optionally after box-filtering both images, which
averages away the independent Monte Carlo noise of two samplers of the
same integral."""
from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB between two images (same shape)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def box_downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Average ``factor`` x ``factor`` blocks (crops a remainder edge)."""
    h, w = img.shape[:2]
    h2, w2 = h // factor, w // factor
    img = img[:h2 * factor, :w2 * factor].astype(np.float64)
    return img.reshape(h2, factor, w2, factor, -1).mean(axis=(1, 3))


def golden_psnr(render01: np.ndarray, golden_u8: np.ndarray,
                downsample: int = 1) -> dict:
    """Compare a [0, 1] tonemapped render with an 8-bit golden:
    ``{"psnr_db", "mean_ours", "mean_golden"}``, and with ``downsample >
    1`` also ``psnr_ds_db`` of the box-filtered images and ``downsample``."""
    ours = np.clip(np.asarray(render01) * 255.99, 0, 255)
    gold = np.asarray(golden_u8, np.float64)
    out = {
        "psnr_db": round(psnr(ours, gold), 2),
        "mean_ours": round(float(ours.mean()), 2),
        "mean_golden": round(float(gold.mean()), 2),
    }
    if downsample > 1:
        out["psnr_ds_db"] = round(
            psnr(box_downsample(ours, downsample),
                 box_downsample(gold, downsample)), 2)
        out["downsample"] = downsample
    return out
