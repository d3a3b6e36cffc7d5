"""The plain reference's arithmetic helpers: the counter-based sampler, the
division and root forms with NaN-free gradients, 3-vector math, the
shading-frame trigonometry, the special-function fits and the Sobol
pixel jitter.

A frozen copy of ``srt_tpu_torch/core/{rng,gradsafe,vecmath,frame,approx,
sobol}.py`` as they stood when the benchmark was written, with nothing of
the program imported: every random number is a pure function of ``(seed,
pixel, sample, bounce, dimension)``, so the reference draws the words the
program draws, and the fits are the ones the program's kernels evaluate.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# --- sampler (srt_tpu_torch/core/rng.py) --------------------------------
MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``x`` in ``[0, 2**32)`` without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def as_word(x) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) -> int64 words."""
    return x.to(torch.int64) & MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """xxhash/PCG-style avalanche on 32-bit words."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_combine(a: torch.Tensor, b) -> torch.Tensor:
    """Combine two 32-bit words into a well-mixed word (``_mix`` is a
    bijection, so distinct ``a`` give distinct streams for fixed ``b``)."""
    return _mix((_mix(a) + (b ^ 0x9E3779B9)) & MASK32)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit word -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def create_salt(seed: int, pixel_id: torch.Tensor,
                sample_id: torch.Tensor) -> torch.Tensor:
    """``RaySampler.create(seed, pix, samp).salt``."""
    return hash_combine(as_word(pixel_id),
                        hash_combine(as_word(sample_id), int(seed) & MASK32))


def bits(salt: torch.Tensor, dim: int) -> torch.Tensor:
    """``RaySampler.bits``: the word of static dimension ``dim``."""
    return hash_combine(salt, (0xB5297A4D + 0x68E31DA4 * dim) & MASK32)


def uniform(salt: torch.Tensor, dim: int) -> torch.Tensor:
    """``RaySampler.uniform``: (N,) float32 in [0, 1) for dimension ``dim``."""
    return bits_to_uniform(bits(salt, dim))


# --- gradient-safe forms (srt_tpu_torch/core/gradsafe.py) --------------

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


# --- vectors (srt_tpu_torch/core/vecmath.py) ---------------------------

def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Unit vector: times the reciprocal of the clamped length (NaN-free
    gradient at the zero vector)."""
    inv = gsrecip(torch.clamp(grad_safe_sqrt(dot(a, a)), min=eps))
    return a * inv[..., None]


def safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit vector; degenerate input (|v|^2 <= eps) maps to +z."""
    l2 = dot(v, v)
    ok = l2 > eps
    up = torch.zeros_like(v)
    up[..., 2] = 1.0
    return (torch.where(ok[..., None], v, up)
            / torch.sqrt(torch.where(ok, l2, 1.0))[..., None])


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(x, 0))`` with +0 on clamped lanes."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def where3(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Select between ``(..., 3)`` tensors with a ``(...)`` mask."""
    return torch.where(mask[..., None], a, b)


def onb_from_w(n: torch.Tensor):
    """Orthonormal basis ``(u, v, w)`` about ``n`` (``onb.h:6-30``): the
    helper axis is +y where |w.x| > 0.9, else +x."""
    w = normalize(n)
    a = torch.zeros_like(w)
    big_x = torch.abs(w[..., 0]) > 0.9
    a[..., 0] = torch.where(big_x, 0.0, 1.0)
    a[..., 1] = torch.where(big_x, 1.0, 0.0)
    v = normalize(cross(w, a))
    return cross(w, v), v, w


def to_world(basis, a: torch.Tensor) -> torch.Tensor:
    u, v, w = basis
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w


def to_local(basis, a: torch.Tensor) -> torch.Tensor:
    u, v, w = basis
    return torch.stack([dot(a, u), dot(a, v), dot(a, w)], -1)


# --- shading frame (srt_tpu_torch/core/frame.py) -----------------------

def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return grad_safe_sqrt(1.0 - cos2_theta(w))


def tan_theta(w):
    """Sign-preserving, finite-safe tan."""
    c = w[..., 2]
    safe = torch.where(torch.abs(c) < 1e-8, torch.sign(c) * 1e-8 + 1e-20, c)
    return sin_theta(w) / safe


def tan2_theta(w):
    return gsdiv(sin2_theta(w), torch.clamp(cos2_theta(w), min=1e-20))


def cos_phi(w):
    st = sin_theta(w)
    return torch.where(st == 0.0, 1.0, torch.clamp(
        gsdiv(w[..., 0], torch.clamp(st, min=1e-20)), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return torch.where(st == 0.0, 0.0, torch.clamp(
        gsdiv(w[..., 1], torch.clamp(st, min=1e-20)), -1.0, 1.0))


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


# --- fits (srt_tpu_torch/core/approx.py) -------------------------------

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


# --- Sobol jitter (srt_tpu_torch/core/sobol.py) ------------------------

# (d, s, a, [m_1..m_s]) rows of the public Joe-Kuo new-joe-kuo-6 table,
# dimensions 2..32 (dimension 1 is the van der Corput sequence).
_JOE_KUO_HEAD = [
    (2, 1, 0, [1]),
    (3, 2, 1, [1, 3]),
    (4, 3, 1, [1, 3, 1]),
    (5, 3, 2, [1, 1, 1]),
    (6, 4, 1, [1, 1, 3, 3]),
    (7, 4, 4, [1, 3, 5, 13]),
    (8, 5, 2, [1, 1, 5, 5, 17]),
    (9, 5, 4, [1, 1, 5, 5, 5]),
    (10, 5, 7, [1, 1, 7, 11, 19]),
    (11, 5, 11, [1, 1, 5, 1, 1]),
    (12, 5, 13, [1, 1, 1, 3, 11]),
    (13, 5, 14, [1, 3, 5, 5, 31]),
    (14, 6, 1, [1, 3, 3, 9, 7, 49]),
    (15, 6, 13, [1, 1, 1, 15, 21, 21]),
    (16, 6, 16, [1, 3, 1, 13, 27, 49]),
    (17, 6, 19, [1, 1, 1, 15, 7, 5]),
    (18, 6, 22, [1, 3, 1, 15, 13, 25]),
    (19, 6, 25, [1, 1, 5, 5, 19, 61]),
    (20, 7, 1, [1, 3, 7, 11, 23, 15, 103]),
    (21, 7, 4, [1, 3, 7, 13, 13, 15, 69]),
    (22, 7, 7, [1, 1, 3, 13, 7, 35, 63]),
    (23, 7, 8, [1, 3, 5, 9, 1, 25, 53]),
    (24, 7, 14, [1, 3, 1, 13, 9, 35, 107]),
    (25, 7, 19, [1, 3, 1, 5, 27, 61, 31]),
    (26, 7, 21, [1, 1, 5, 11, 19, 41, 61]),
    (27, 7, 28, [1, 3, 5, 3, 3, 13, 69]),
    (28, 7, 31, [1, 1, 7, 13, 1, 19, 1]),
    (29, 7, 32, [1, 3, 7, 5, 13, 19, 59]),
    (30, 7, 37, [1, 1, 3, 9, 25, 29, 41]),
    (31, 7, 41, [1, 3, 5, 13, 23, 1, 55]),
    (32, 7, 42, [1, 3, 7, 3, 13, 59, 17]),
]


def _direction_vectors(L: int, s: int, a: int, m: list[int]) -> np.ndarray:
    """V[1..L] scaled by 2^32 for one dimension (Joe-Kuo recursion,
    mirrors the math at ``Raytracing_n.cpp:781-793``)."""
    V = np.zeros(L + 1, dtype=np.uint64)
    if L <= s:
        for i in range(1, L + 1):
            V[i] = np.uint64(m[i - 1]) << np.uint64(32 - i)
    else:
        for i in range(1, s + 1):
            V[i] = np.uint64(m[i - 1]) << np.uint64(32 - i)
        for i in range(s + 1, L + 1):
            V[i] = V[i - s] ^ (V[i - s] >> np.uint64(s))
            for k in range(1, s):
                V[i] ^= np.uint64((a >> (s - 1 - k)) & 1) * V[i - k]
    return V


def sobol_points(n: int, d: int) -> np.ndarray:
    """First ``n`` points of the ``d``-dimensional Sobol sequence, (n, d)
    float64, by the gray-code construction of the reference."""
    if n < 1:
        return np.zeros((0, d))
    if d > len(_JOE_KUO_HEAD) + 1:
        raise ValueError(f"sobol dimension {d} > {len(_JOE_KUO_HEAD) + 1}")
    L = max(1, int(np.ceil(np.log2(max(n, 2)))))

    # C[i] = index (from 1) of the lowest zero bit of i.
    C = np.ones(n, dtype=np.uint32)
    for i in range(1, n):
        value = i
        while value & 1:
            value >>= 1
            C[i] += 1

    # dim 0 is van der Corput: all m_i = 1 with no recursion (s = L).
    Vs = [_direction_vectors(L, L, 0, [1] * L)]
    for j in range(1, d):
        _, s, a, m = _JOE_KUO_HEAD[j - 1]
        Vs.append(_direction_vectors(L, s, a, m))

    points = np.zeros((n, d))
    X = np.zeros(d, dtype=np.uint64)
    inv = 1.0 / float(1 << 32)
    for i in range(1, n):
        for j in range(d):
            X[j] ^= Vs[j][C[i - 1]]
            points[i, j] = float(X[j]) * inv
    return points
