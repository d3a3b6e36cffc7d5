"""The agreement contract between two implementations of the bounce.

Two float programs of the same path-tracing math agree lane by lane only
up to rounding, and rounding decides near-tie branches (the winning hit,
the VNDF ``cosThetaI > 0.9999`` split, a pdf at the floor). A flipped
branch resamples that path, so the contract bounds the share of lanes
that disagree and requires the typical lane to agree closely. The bounds
are the JAX package's own, from its kernel-against-XLA tests
(``tests/test_fused_bounce.py:154-183``); images are compared by
statistics for the same reason.
"""
from __future__ import annotations

import numpy as np

#: per-bounce: (key, |Δ| tolerance, largest share of lanes beyond it)
BOUNCE_TOLERANCES = (("d", 1e-4, 0.05), ("beta", 1e-3, 0.05),
                     ("radiance", 1e-3, 0.01))
ALIVE_MISMATCH = 2e-3
MEDIAN = 1e-5
#: under the parity estimator, the heap slot after the bounce
#: (``tests/test_fused_bounce.py:324-340``)
STALE_TOLERANCE = ("stale", 1e-3, 0.05)
#: MERL's table index (``materials/merl.py:half_diff_indices``) truncates
#: three angles; an angle within rounding of a bin edge takes the next bin
#: on another backend's arccos and atan2. The largest share of directions
#: whose index may differ: 20x the first measurement, 5 of 1,000,000
#: seeded hemisphere pairs against JAX's XLA on the CPU (0 of 100,000).
MERL_INDEX_MISMATCH = 1e-4


def _tolerances(a: dict) -> tuple:
    return BOUNCE_TOLERANCES + ((STALE_TOLERANCE,) if "stale" in a else ())


def wavefront_arrays(st: dict) -> dict:
    """The compared fields of a ``kernels.bounce`` wavefront, as numpy."""
    return {"alive": (st["alive"] != 0).cpu().numpy(),
            **{k: st[k].T.cpu().numpy() for k in ("d", "beta", "radiance")}}


def bounce_agreement(a: dict, b: dict) -> dict:
    """Measured agreement of two next-bounce states (numpy: ``alive``
    (N,) bool, ``d beta radiance`` (N, 3), under parity ``stale`` (N,)).
    ``d``, ``beta`` and ``stale`` are compared on the lanes ``a`` keeps
    alive; other lanes' values are don't-care."""
    live = np.asarray(a["alive"], bool)
    out = {"alive_mismatch": float((live != np.asarray(b["alive"], bool))
                                   .mean())}
    for key, tol, _ in _tolerances(a):
        da = np.abs(np.asarray(a[key], np.float64)
                    - np.asarray(b[key], np.float64))
        if da.ndim == 2:
            da = da.max(-1)
        if key != "radiance":
            da = np.where(live, da, 0.0)
        out[key] = {"frac_bad": float((da > tol).mean()),
                    "median": float(np.median(da)), "max": float(da.max())}
    return out


def check_bounce(a: dict, b: dict) -> dict:
    """Raise ``AssertionError`` unless ``a`` and ``b`` meet the per-bounce
    contract; returns the measured agreement."""
    m = bounce_agreement(a, b)
    if m["alive_mismatch"] > ALIVE_MISMATCH:
        raise AssertionError(f"alive mismatch {m['alive_mismatch']}: {m}")
    for key, _, frac in _tolerances(a):
        if m[key]["frac_bad"] > frac or m[key]["median"] > MEDIAN:
            raise AssertionError(f"{key} beyond the contract: {m}")
    return m


#: per-bounce gradients: an entry is off when |Δ| exceeds GRAD_RTOL of
#: the reference entry plus GRAD_ATOL of the reference's largest entry
#: (GRAD_RTOL is the JAX package's kernel-backward bound,
#: tests/test_diff.py:334-335); at most GRAD_FRAC of the lanes may hold an
#: entry that is off
GRAD_RTOL = 2e-3
GRAD_ATOL = 1e-5
GRAD_FRAC = 1e-2


def grad_agreement(ref: dict, got: dict) -> dict:
    """Measured agreement of per-lane gradients (numpy, (N, k) or (N,)
    each): the share of lanes with an entry beyond the bound, the largest
    |Δ| and the largest |Δ| relative to the reference's largest entry."""
    bad = None
    worst, scale = 0.0, 0.0
    for key in ref:
        a = np.asarray(ref[key], np.float64).reshape(len(ref[key]), -1)
        b = np.asarray(got[key], np.float64).reshape(len(ref[key]), -1)
        scale = max(scale, float(np.abs(a).max(initial=0.0)))
        worst = max(worst, float(np.abs(a - b).max(initial=0.0)))
        off = (np.abs(a - b) > GRAD_RTOL * np.abs(a)
               + GRAD_ATOL * np.abs(a).max(initial=0.0)).any(-1)
        bad = off if bad is None else bad | off
    return {"frac_bad": float(bad.mean()), "max_abs": worst,
            "max_rel": worst / max(scale, 1e-30),
            "finite": bool(all(np.isfinite(np.asarray(got[k])).all()
                               for k in got))}


def check_grads(ref: dict, got: dict, frac: float = GRAD_FRAC) -> dict:
    """Raise ``AssertionError`` unless ``got`` is finite and agrees with
    ``ref`` lane by lane within the gradient bound on all but ``frac`` of
    the lanes; returns the measured agreement."""
    m = grad_agreement(ref, got)
    if not m["finite"] or m["frac_bad"] > frac:
        raise AssertionError(f"gradients beyond the contract: {m}")
    return m


def image_agreement(a: np.ndarray, b: np.ndarray) -> dict:
    """|Δmean|, median per-pixel |Δ| and the share of pixels beyond 1e-2."""
    diff = np.abs(np.asarray(a, np.float64)
                  - np.asarray(b, np.float64)).max(-1)
    return {"mean_diff": float(abs(np.mean(a) - np.mean(b))),
            "median": float(np.median(diff)),
            "frac_bad": float((diff > 1e-2).mean())}


def check_image(a: np.ndarray, b: np.ndarray, frac_bad: float = 0.15,
                mean_diff: float = 3e-3, median: float = 1e-5) -> dict:
    """Raise ``AssertionError`` unless both images are finite and agree
    by mean, median pixel and the share of pixels off by more than 1e-2."""
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise AssertionError("non-finite pixels")
    m = image_agreement(a, b)
    if (m["mean_diff"] >= mean_diff or m["median"] >= median
            or m["frac_bad"] >= frac_bad):
        raise AssertionError(f"images beyond the contract: {m}")
    return m
