"""Special-function fits shared by the plain bounce and the CUDA kernel
(counterpart of ``srt_tpu/core/approx.py``, reference ``common.h:26-78``).

The Beckmann VNDF inversion consumes these curves, not libm's: using the
same fits on every path keeps the sample streams of the JAX package, the
plain PyTorch bounce and ``csrc/regen_bounce.cu`` aligned. So the port
does not use ``torch.erf``/``torch.erfinv``/``torch.acos`` here.
"""
from __future__ import annotations

import math

import torch

_ERFINV_CENTRAL = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164,
                   0.246640727, 1.50140941)
_ERFINV_TAIL = (0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047,
                1.00167406, 2.83297682)


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """A&S 7.1.26 erf; |err| <= 1.5e-7."""
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * torch.exp(-ax * ax)
    return s * y


def erf_reference_buggy(x: torch.Tensor) -> torch.Tensor:
    """The reference's Erf as implemented (``common.h:40-44``), not erf:
    its A&S evaluation adds the exponential instead of multiplying the
    polynomial by it. The parity estimator's Beckmann sampler bounds its
    bisection with this curve, as the reference's does."""
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly_t = (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
               - 0.284496736) * t + 0.254829592) * t
    return s * (1.0 - poly_t + torch.exp(-ax * ax))


def erfinv_giles(x: torch.Tensor) -> torch.Tensor:
    """Giles (2010) single-precision erfinv."""
    x = torch.clamp(x, -0.99999, 0.99999)
    w = -torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-30))
    wc = w - 2.5
    p = torch.full_like(x, 2.81022636e-08)
    for c in _ERFINV_CENTRAL:
        p = c + p * wc
    wt = torch.sqrt(torch.clamp(w, min=1e-30)) - 3.0
    q = torch.full_like(x, -0.000200214257)
    for c in _ERFINV_TAIL:
        q = c + q * wt
    return torch.where(w < 5.0, p, q) * x


def acos_as(x: torch.Tensor) -> torch.Tensor:
    """A&S 4.4.45 acos via reflection; |err| <= 6.7e-5 rad."""
    ax = torch.clamp(torch.abs(x), 0.0, 1.0)
    p = torch.sqrt(1.0 - ax) * (1.5707288 + ax * (-0.2121144
                                                  + ax * (0.0742610
                                                          - 0.0187293 * ax)))
    return torch.where(x >= 0.0, p, math.pi - p)



def cbrt_pos(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a non-negative argument as ``exp(log(x) / 3)``, the
    form the JAX kernel uses for the metal fuzz ball
    (``srt_tpu/pallas/bounce.py:675``), not libm's ``cbrt``."""
    return torch.exp(torch.log(torch.clamp(x, min=1e-30)) * (1.0 / 3.0))
