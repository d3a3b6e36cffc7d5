"""Seeded film flushes of the port's tests, in numpy: each lane's pixel
by layout, radiance of mixed signs and magnitudes with NaN and +-inf, B1's
int32 planes ``fin`` and ``alive``, and a film of non-zero sums.
``tests/test_torch_film_sum.py`` holds the plain version to JAX's scatter
on every layout, ``tests/test_torch_kernel.py`` the film kernel to the
plain version on the card. Imports neither JAX nor torch."""
from __future__ import annotations

import numpy as np

#: a tile of the film kernel (``csrc/film_sum.cu``'s kThreads)
TILE = 256


def _every_tile(r, n):
    """Pixel 0 twice in every tile, the rest over 400 pixels: a pixel of
    hundreds of records, more than a warp's batch of 32."""
    pix = r.integers(1, 400, n)
    pix[::TILE] = 0
    pix[TILE // 2::TILE] = 0
    return pix


def _records(r, n):
    """Pixel k (1..40) one lane in each of k tiles, and pixel 40 + L
    (1..32) L lanes in one tile, the rest over 2,000 pixels: with 70% of
    the lanes finished, pixels of about seven and eight records (the
    kernel's row holds seven) and of about 16 and 17 lanes (one thread
    adds 16)."""
    pix = r.integers(100, 2100, n)
    tiles = n // TILE
    for k in range(1, 41):
        for t in r.choice(tiles, size=min(k, tiles), replace=False):
            pix[t * TILE + k] = k
    for length in range(1, 33):
        t = r.integers(tiles)
        pix[t * TILE + 64 + np.arange(length)] = 40 + length
    return pix


#: name: (lanes, the lanes' pixels from a generator and the lanes):
#: scattered over 500 pixels (a record in nearly every tile a pixel), runs
#: of 1,024 lanes a pixel (the camera rays of 1,024 samples that finish
#: together), a 64-lane run a pixel, repeated (a record or two a pixel),
#: scattered over a 300,000-lane wavefront (more tiles than a block each,
#: and than 32 bitmap words a pixel), a pixel in every tile, one pixel
#: filling each tile, runs of 100 lanes across tile edges, the row's seven
#: records and one thread's 16 lanes at their edges, and one pixel over
#: the whole wavefront.
FILM_LAYOUTS = {
    "scattered": (30000, lambda r, n: r.integers(0, 500, n)),
    "runs-1024": (30000, lambda r, n: np.arange(n) // 1024),
    "runs-64": (30000, lambda r, n: (np.arange(n) // 64) % 300),
    "wide": (300000, lambda r, n: r.integers(0, 700, n)),
    "every-tile": (30000, _every_tile),
    "tile-fill": (30000, lambda r, n: np.arange(n) // TILE),
    "straddle": (30000, lambda r, n: (np.arange(n) + 37) // 100),
    "records": (40000, _records),
    "one-pixel": (20000, lambda r, n: np.zeros(n, np.int64)),
}


def film_flush(layout: str, seed: int = 4, lanes: int | None = None) -> tuple:
    """One seeded flush in ``layout`` (at ``lanes`` lanes in place of the
    layout's own): ``(acc0 (3, pixels), pix, rad (3, n), fin, alive)``,
    float32 and int32, 70% of the lanes finished, 30% alive, 1% of
    radiance NaN and 0.3% each +inf and -inf."""
    r = np.random.default_rng(seed)
    n, pixels_of = FILM_LAYOUTS[layout]
    n = lanes or n
    pix = pixels_of(r, n).astype(np.int32)
    pixels = int(pix.max()) + 1
    rad = (r.standard_normal((3, n))
           * 10.0 ** r.integers(-3, 4, (1, n))).astype(np.float32)
    rad[r.random((3, n)) < 0.01] = np.nan
    rad[r.random((3, n)) < 0.003] = np.inf
    rad[r.random((3, n)) < 0.003] = -np.inf
    fin = (r.random(n) < 0.7).astype(np.int32)
    alive = (r.random(n) < 0.3).astype(np.int32)
    acc0 = r.standard_normal((3, pixels)).astype(np.float32)
    return acc0, pix, rad, fin, alive
