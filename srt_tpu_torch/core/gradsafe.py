"""Square root, division and reciprocal with NaN-free gradients
(counterpart of ``srt_tpu/pallas/bounce.py:111-154``: ``_grad_safe_sqrt``,
``_gsdiv``, ``_gsrecip``).

Each returns the plain form's value bit for bit; only the gradient
differs, and only where the plain form's is not finite:

* ``grad_safe_sqrt(x)`` is ``sqrt(max(x, 0))`` with a zero gradient where
  ``x <= 0``. Autograd of the plain form multiplies ``sqrt'(0) = inf`` by
  the clamp's zero and gets NaN there.
* ``gsdiv(num, den)`` is ``num / den`` whose denominator coefficient
  ``-num / den**2`` is clamped to +-3e37. Against the 1e-20 guard floors of
  the sampling math the plain coefficient overflows to inf, and a masked
  lane's zero cotangent times inf is NaN (the JAX package's minimal
  repro: the gradient of ``1 / max(x - 1, 1e-20)`` at ``x = 1``).
* ``gsrecip(den)`` is ``gsdiv(1, den)``.

The CUDA backward kernel (``csrc/bounce_core.cuh``, ``Dual``) carries the
same two rules: a sqrt tangent of 0 where ``x <= 0``, and every division's
coefficient clamped.
"""
from __future__ import annotations

import torch

COEF_MAX = 3e37


def grad_safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(x, 0))`` with a zero gradient where ``x <= 0``."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


class _GsDiv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num, den):
        ctx.save_for_backward(num, den)
        return num / den

    @staticmethod
    def backward(ctx, g):
        num, den = ctx.saved_tensors
        inv = 1.0 / den
        coef = torch.clamp(-(num * inv) * inv, -COEF_MAX, COEF_MAX)
        g_num = g * inv if ctx.needs_input_grad[0] else None
        g_den = g * coef if ctx.needs_input_grad[1] else None
        return g_num, g_den


def gsdiv(num, den) -> torch.Tensor:
    """``num / den`` with the denominator's gradient coefficient clamped
    to +-3e37. Either argument may be a Python number."""
    if not isinstance(den, torch.Tensor):
        return num / den
    if not isinstance(num, torch.Tensor):
        num = torch.full_like(den, float(num))
    num, den = torch.broadcast_tensors(num, den)
    return _GsDiv.apply(num, den)


def gsrecip(den: torch.Tensor) -> torch.Tensor:
    """``1 / den`` with a clamped gradient coefficient."""
    return gsdiv(1.0, den)
