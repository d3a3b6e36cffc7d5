"""The numbers that decide ``correct``: what the timed path produced
against the plain reference (``benchmark/reference/``), each held to its
limit from ``limits/<cell>.json``.

Renders: the image's value at a sample of pixels drawn from the seed,
program against reference, pixel by pixel. Both trace the same paths (the
sampler is a pure function of seed, pixel, sample, bounce and dimension),
so they differ only where rounding flips a branch, and in the order of a
pixel's sums. The median gap sees a fault that moves most pixels. A
fault that moves a few pixels in a hundred or in ten (one branch of the
film, one material, a tile's edge) shows in four more numbers, of which
each cell holds those that its sound runs leave room for: ``p99_gap``,
the 99th percentile of the pixels' gaps (a pixel's gap is its worst
channel's); ``moved_share``, the share of pixels moved beyond rounding;
``sign_skew``, how far the moved pixels lean to one side; ``mean_gap``,
the relative gap of the pixels' means. A flipped branch moves one of a
pixel's samples, brightening it as often as it darkens it; a fault leans
one way.

Train steps: the loss of each of the first three steps, the first step's
gradient as the optimizer got it, and the parameters' change after the
three. Gradient and change are taken leaf by leaf (a leaf is one row of
``tex_color``, one texture's colour): the gap between the program's norm
and the reference's, against the larger of the reference's norm of that
leaf and of the median leaf. A leaf whose reference gradient is under a
thousandth of the median leaf's (an image texture's row, which no lane
reads) is left out of both. The change is taken by the worst leaf
(``step_gap``) and by the median leaf (``step_gap_median``). Adam divides
each channel's step by its gradient's size plus 1e-8, so a channel whose
gradient nearly cancels, to the order of 1e-8, takes a step that follows
the last bits of its gradient: the worst leaf's gap swings with them from
seed to seed, the median leaf's does not.
"""
from __future__ import annotations

import numpy as np

#: a pixel channel off by more than this counts for ``off_share``
OFF = 1e-2
#: a pixel has moved when its worst channel's gap passes this share of
#: its brightest reference channel, plus :data:`MOVED_FLOOR`: a hundred
#: times the rounding of a pixel's sums taken in another order
MOVED = 1e-4
MOVED_FLOOR = 1e-6
#: a leaf with a reference gradient under this share of the median
#: leaf's is left out
LEAF_FLOOR = 1e-3


def render_numbers(prog: np.ndarray, ref: np.ndarray) -> dict:
    """``prog``, ``ref``: (P, 3) pixel values at the sampled pixels."""
    signed = prog.astype(np.float64) - ref.astype(np.float64)
    d = np.where(np.isfinite(signed), np.abs(signed), np.inf)
    ref_mean = float(np.mean(ref))
    gap = d.max(axis=1)
    moved = gap > MOVED * np.abs(ref).max(axis=1) + MOVED_FLOOR
    up = np.nan_to_num(signed, nan=0.0).sum(axis=1) > 0
    n_up = int(np.sum(moved & up))
    n_moved = int(np.sum(moved))
    return {
        "median_gap": float(np.median(d)),
        "p99_gap": float(np.quantile(gap, 0.99)),
        "moved_share": n_moved / len(gap),
        "sign_skew": abs(2 * n_up - n_moved) / max(n_moved, 1),
        "off_share": float(np.mean((d > OFF).any(axis=1))),
        "mean_gap": (abs(float(np.mean(prog.astype(np.float64))) - ref_mean)
                     / max(abs(ref_mean), 1e-12)),
        "max_gap": float(d.max()),
    }


def _leaf_gaps(prog: np.ndarray, ref: np.ndarray,
               keep: np.ndarray) -> np.ndarray:
    np_, nr = (np.linalg.norm(x.astype(np.float64), axis=1)
               for x in (prog, ref))
    med = float(np.median(nr[keep])) if keep.any() else 0.0
    gaps = np.abs(np_ - nr)[keep] / np.maximum(nr[keep], max(med, 1e-30))
    gaps = np.where(np.isfinite(gaps), gaps, np.inf)
    return gaps


def _worst(gaps: np.ndarray) -> float:
    return float(gaps.max()) if gaps.size else 0.0


def train_numbers(prog: dict, ref: dict, p0: np.ndarray) -> dict:
    """``prog`` and ``ref``: ``losses`` of the first steps, ``grad1`` the
    first gradient and ``params`` after the last, (leaves, 3) arrays;
    ``p0`` the parameters before the first step."""
    lp = np.asarray(prog["losses"], np.float64)
    lr = np.asarray(ref["losses"], np.float64)
    loss_gap = np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)
    rg = np.linalg.norm(np.asarray(ref["grad1"], np.float64), axis=1)
    keep = rg >= LEAF_FLOOR * float(np.median(rg))
    steps = _leaf_gaps(np.asarray(prog["params"]) - p0,
                       np.asarray(ref["params"]) - p0, keep)
    return {
        "loss_gap": float(np.max(np.where(np.isfinite(loss_gap), loss_gap,
                                          np.inf))),
        "grad_gap": _worst(_leaf_gaps(np.asarray(prog["grad1"]),
                                      np.asarray(ref["grad1"]), keep)),
        "step_gap": _worst(steps),
        "step_gap_median": float(np.median(steps)) if steps.size else 0.0,
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict, dict]:
    """``correct``, each compared number with its limit (for the result
    line), and the numbers that have no limit, which are reported and
    decide nothing."""
    compared, other = {}, {}
    for name, value in numbers.items():
        limit = limits.get(name)
        if limit is None:
            other[name] = value
        else:
            compared[name] = {"value": value, "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    return correct and bool(compared), compared, other
