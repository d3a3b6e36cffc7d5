"""Tone mapping of a finished image (counterpart of
``srt_tpu/render/film.py:13-21``): the reference's writeback is mean, then
sqrt gamma, then a clamp to [0, 255] (``Raytracing_n.cpp:848-867``)."""
from __future__ import annotations

import torch


def tonemap(linear: torch.Tensor) -> torch.Tensor:
    """sqrt gamma and a clamp to [0, 1] (``Raytracing_n.cpp:850-862``)."""
    return torch.clamp(torch.sqrt(torch.clamp(linear, min=0.0)), 0.0, 1.0)


def to_uint8(img01: torch.Tensor) -> torch.Tensor:
    """The reference's 255.99 quantization (``Raytracing_n.cpp:853-855``)."""
    return torch.clamp(255.99 * img01, 0.0, 255.0).to(torch.uint8)
