"""The fixed-order sums (ROADMAP C18) against the JAX package's.

The regeneration engine's film (``kernels/film.py``) and the train
backward's material sum (``kernels/segment.py``) run their plain versions
here, ``index_add_`` on the CPU, which adds lane after lane as XLA's CPU
scatter does: the sums are JAX's ``.at[].add`` to the bit, compared as raw
float32 words (a pixel that adds +inf and -inf is NaN in both, with the
same bits). The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_kernel.py``, ``chip_smoke.py`` phase 38). The render
test holds ``render_regen`` to JAX's engine under the image contract of
``tests/test_torch_render.py`` and ``tests/test_torch_tris.py``.
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_flushes import FILM_LAYOUTS, film_flush

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu.render.regen import render_regen as jax_render_regen
from srt_tpu.scene.library import get_scene as jax_get_scene
from srt_tpu_torch import RenderConfig, convert, render_regen
from srt_tpu_torch import trace as tracer
from srt_tpu_torch.kernels import launch_counts
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.kernels import film as kfilm
from srt_tpu_torch.kernels import segment as kseg
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)


REGEN, STEP = "regen", "step"


def _flushes(form: str, n=4096, pixels=64, flushes=3, seed=0):
    """Seeded flushes into a few pixels (about 40 finished lanes a pixel a
    flush): radiance (N, 3) of mixed signs and magnitudes with NaN and
    +-inf; the masks as B1's int32 planes ``fin`` and ``alive`` after the
    bounce (``form`` REGEN) or as the per-bounce loop's bools, alive
    before the bounce and after the depth cap (STEP)."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(flushes):
        rad = (r.standard_normal((n, 3))
               * 10.0 ** r.integers(-4, 5, (n, 1))).astype(np.float32)
        rad[r.random((n, 3)) < 0.01] = np.nan
        rad[r.random((n, 3)) < 0.004] = np.inf
        rad[r.random((n, 3)) < 0.004] = -np.inf
        a, b = r.random(n) < 0.6, r.random(n) < 0.3
        if form == REGEN:
            m0, m1 = a.astype(np.int32), b.astype(np.int32)
        else:
            m0, m1 = a, a & b
        out.append((r.integers(0, pixels, n), rad, m0, m1))
    return out


def _film_args(form: str, pix, rad, m0, m1) -> tuple:
    """The film's arguments from one of :func:`_flushes`, as each loop of
    ``render/regen.py`` builds them: B1's planes as they are, the
    per-bounce loop's from its bools."""
    pix_t = torch.from_numpy(pix)
    if form == REGEN:
        return (pix_t.int(), torch.from_numpy(np.ascontiguousarray(rad.T)),
                torch.from_numpy(m0), torch.from_numpy(m1))
    was, alive = torch.from_numpy(m0), torch.from_numpy(m1)
    return (pix_t.int(), torch.from_numpy(rad).T.contiguous(),
            (was & ~alive).int(), alive.int())


def _jax_flushes(flushes, form: str, pixels: int):
    """JAX's flush (``srt_tpu/render/regen.py:108-122``), once a flush."""
    acc = jnp.zeros((pixels, 3), jnp.float32)
    n_vertices = nan_scrubbed = 0
    for pix, rad, m0, m1 in flushes:
        if form == REGEN:
            fin, was_alive = m0 != 0, (m1 != 0) | (m0 != 0)
        else:
            fin, was_alive = m0 & ~m1, m0
        contrib = jnp.where(jnp.asarray(fin)[:, None], jnp.asarray(rad), 0.0)
        is_nan = jnp.isnan(contrib)
        contrib = jnp.where(is_nan, 0.0, contrib)
        acc = acc.at[jnp.asarray(pix)].add(contrib)
        n_vertices += int(jnp.sum(jnp.asarray(was_alive), dtype=jnp.uint32))
        nan_scrubbed += int(jnp.sum(is_nan, dtype=jnp.uint32))
    return np.asarray(acc), n_vertices, nan_scrubbed


@pytest.mark.parametrize("form", [REGEN, STEP])
def test_film_sum_is_jax_scatter_to_the_bit(form):
    pixels = 64
    flushes = _flushes(form, pixels=pixels)
    film = kfilm.Film(pixels, 4096, "cpu")
    for f in flushes:
        film.flush(*_film_args(form, *f))
    acc_j, n_vertices_j, nan_scrubbed_j = _jax_flushes(flushes, form, pixels)
    got = film.acc.T.contiguous().numpy()
    assert np.isnan(got).any() and np.isinf(got).any()
    np.testing.assert_array_equal(got.view(np.uint32), acc_j.view(np.uint32))
    assert int(film.n_vertices) == n_vertices_j
    assert int(film.nan_scrubbed) == nan_scrubbed_j > 0
    assert launch_counts()["film_sum"] == 0


@pytest.mark.parametrize("layout", list(FILM_LAYOUTS))
def test_film_layouts_are_jax_scatter_to_the_bit(layout):
    """The plain version on the film kernel's edge cases
    (``tests/_torch_flushes.py``, which the card test
    ``test_film_kernel_matches_plain_on_gpu`` runs through the kernel):
    sums from a non-zero film equal to JAX's ``.at[].add`` to the bit, and
    the counts."""
    acc0, pix, rad, fin, alive = film_flush(layout)
    film = kfilm.Film(acc0.shape[1], pix.shape[0], "cpu")
    film.acc.copy_(torch.from_numpy(acc0))
    film.flush(*(torch.from_numpy(x) for x in (pix, rad, fin, alive)))
    done = fin != 0
    contrib = jnp.where(jnp.asarray(done)[:, None], jnp.asarray(rad.T), 0.0)
    is_nan = jnp.isnan(contrib)
    want = np.asarray(jnp.asarray(acc0.T).at[jnp.asarray(pix)].add(
        jnp.where(is_nan, 0.0, contrib)))
    got = film.acc.T.contiguous().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert int(film.n_vertices) == int(((alive != 0) | done).sum())
    assert int(film.nan_scrubbed) == int(is_nan.sum()) > 0


def test_film_on_the_cpu_is_the_plain_version(monkeypatch):
    """On the CPU the film adds with the plain version and launches
    nothing; a film that is not plain needs the card."""
    monkeypatch.setitem(tracer.COUNTS, "film_sum", 0)
    (f,) = _flushes(REGEN, flushes=1, seed=1)
    args = _film_args(REGEN, *f)
    film = kfilm.Film(64, 4096, "cpu")
    film.flush(*args)
    want = [torch.zeros((3, 64)), torch.zeros((), dtype=torch.int64),
            torch.zeros((), dtype=torch.int64)]
    kfilm.film_sum_reference(*want, *args)
    assert torch.equal(film.acc.view(torch.int32), want[0].view(torch.int32))
    assert (int(film.n_vertices), int(film.nan_scrubbed)) == (
        int(want[1]), int(want[2]))
    assert launch_counts()["film_sum"] == 0
    with pytest.raises(ValueError, match="no film kernel"):
        kfilm.Film(64, 4096, "meta")


def test_material_sum_is_jax_scatter_to_the_bit():
    """B5's per-lane material cotangents (N, 10) summed by material as
    ``srt_tpu/pallas/bounce_bwd.py:308-315`` sums them, column group by
    column group, against the plain version's (M, 14) table."""
    r = np.random.default_rng(2)
    n, m = 8192, 20
    g = (r.standard_normal((n, 10))
         * 10.0 ** r.integers(-6, 3, (n, 1))).astype(np.float32)
    mid = r.integers(0, m, n).astype(np.int32)
    got = kseg.material_sum_reference(torch.from_numpy(g),
                                      torch.from_numpy(mid), m).numpy()
    jmid = jnp.asarray(mid)
    want = np.zeros((m, 14), np.float32)
    for lo, hi, cols in ((0, 4, slice(1, 5)), (4, 7, slice(6, 9)),
                         (7, 10, slice(9, 12))):
        want[:, cols] = np.asarray(jnp.zeros((m, hi - lo), jnp.float32)
                                   .at[jmid].add(jnp.asarray(g[:, lo:hi])))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got[:, [0, 5, 12, 13]] == 0).all()


@pytest.mark.parametrize("n", [16384, 262144])
def test_material_sum_order_is_within_the_contract_of_jax(n):
    """The kernel's order of adds in torch (``material_sum_order``, which
    the card test ``test_material_sum_kernel_on_gpu`` and ``chip_smoke.py``
    phase 38 hold the kernel to, to the bit) against JAX's ``.at[].add``
    under the gradient contract on every row (``check_grads``, frac 0), at
    the regen-scan train state's and the scan train step's lanes, one
    material over half of them (the floor); the columns no input feeds
    zero, and an order of its own: not the plain version's bits."""
    r = np.random.default_rng(6)
    m = 124
    g = (r.standard_normal((n, 10))
         * 10.0 ** r.integers(-3, 2, (n, 1))).astype(np.float32)
    mid = r.integers(0, m, n).astype(np.int32)
    mid[: n // 2] = 7
    got = kseg.material_sum_order(torch.from_numpy(g), torch.from_numpy(mid),
                                  m).numpy()
    jmid = jnp.asarray(mid)
    want = np.zeros((m, 14), np.float32)
    want[:, list(kb.MAT_GRAD_COLS)] = np.asarray(
        jnp.zeros((m, 10), jnp.float32).at[jmid].add(jnp.asarray(g)))
    contract.check_grads({"d_mat": want}, {"d_mat": got}, frac=0.0)
    assert (got[:, [0, 5, 12, 13]] == 0).all()
    assert not np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert kseg.chunks_for(n) == (1 if n == 16384 else 8)


def test_material_sum_on_the_cpu_is_the_plain_version(monkeypatch):
    monkeypatch.setitem(tracer.COUNTS, "segment_sum", 0)
    r = np.random.default_rng(3)
    g = torch.from_numpy(r.standard_normal((500, 10)).astype(np.float32))
    mid = torch.from_numpy(r.integers(0, 7, 500).astype(np.int32))
    got = kseg.material_sum(g, mid, 7)
    want = kseg.material_sum_reference(g, mid, 7)
    assert got.shape == (7, 14) and torch.equal(got, want)
    assert launch_counts()["segment_sum"] == 0


@pytest.fixture
def flush_denormals():
    # XLA's CPU backend flushes float32 denormals; do the same here
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("name,frac_bad", [("cornell_boxes", 0.15),
                                           ("ball_scenes", 0.35)])
def test_render_regen_matches_jax(name, frac_bad, flush_denormals,
                                  monkeypatch):
    """Both of ``render_regen``'s loops through the film against JAX's
    engine: ball_scenes takes the B1 loop, cornell_boxes the per-bounce
    loop. The image contract's bound on pixels beyond 1e-2 is 15%, 35% on
    ball_scenes' near-mirror spheres against JAX's jitted engine (C5, as
    in ``tests/test_torch_render.py``)."""
    monkeypatch.delenv("SRT_TPU_PALLAS", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene_j, cam_j, _ = jax_get_scene(name, aspect=1.0)
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    cfg = dict(width=32, height=32, spp=4, max_depth=6)   # the tests' size
    img_j, m_j = jax_render_regen(scene_j, cam_j, JaxRenderConfig(**cfg),
                                  metrics=True)
    img, m = render_regen(scene, cam, RenderConfig(**cfg), metrics=True)
    contract.check_image(img.numpy(), np.asarray(img_j), frac_bad=frac_bad)
    assert m.nan_scrubbed == m_j.nan_scrubbed == 0
    assert abs(m.path_vertices - m_j.path_vertices) < 0.015 * m_j.path_vertices
    assert m.bounce == ("B1" if name == "ball_scenes" else "B2")
