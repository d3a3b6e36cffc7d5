"""The film sum's and the material sum's CUDA sources, run on the CPU.

``csrc/film_sum.cu`` and ``csrc/segment_sum.cu`` are built with g++
through ``tests/_cuda_emulator.py`` (every CUDA thread a host thread,
every block of the grid at once, so the film's grid barrier and the
material sum's waiting blocks meet as on the card); the launch is
rewritten into that emulator's. The film kernel's sums and counts, over
two launches on one film, must equal the plain version's (``index_add_``
lane after lane) to the bit on the shared flush layouts
(``tests/_torch_flushes.py``) cut to a few thousand lanes, with four blocks for the many tiles (each
block several tiles, the hash of its last tile kept in shared memory) and
with a block a tile, and its per-pixel rows and bitmaps must be back at 0.
The material sum's table must equal its order of adds in torch
(``kernels/segment.py:material_sum_order``) to the bit, with its constants
``kFill`` and ``kCombiners`` cut to 2 and 3 so that a few thousand lanes
take several chunks a warp, more than 32 blocks and blocks that wait.
"""
from __future__ import annotations

import os
import re
import subprocess

import _cuda_emulator as emulator
import numpy as np
import pytest
import torch
from _torch_flushes import film_flush

from srt_tpu_torch.kernels import film as kfilm
from srt_tpu_torch.kernels import segment as kseg
from srt_tpu_torch.kernels.bounce import MAT_GRAD_COLS

torch.set_num_threads(1)

_FILM_MAIN = r"""
#include <cstdio>
#include <vector>
#include "film.cu"
// in.bin: int32 n, pixels, reps; float acc (3, pixels); int pix (n);
// float rad (3, n); int fin (n); int alive (n); int64 n_vertices,
// nan_scrubbed. out.bin: acc, n_vertices, nan_scrubbed after reps
// launches on one film. Exit 3 if a row count or bitmap word is left.
int main() {
  FILE* f = std::fopen("in.bin", "rb");
  int h[3];
  if (std::fread(h, 4, 3, f) != 3) return 2;
  const int n = h[0], pixels = h[1], reps = h[2];
  std::vector<float> acc(3 * (size_t)pixels), rad(3 * (size_t)n);
  std::vector<int> pix(n), fin(n), alive(n);
  long long cnt[2];
  if (std::fread(acc.data(), 4, acc.size(), f) != acc.size() ||
      std::fread(pix.data(), 4, n, f) != (size_t)n ||
      std::fread(rad.data(), 4, rad.size(), f) != rad.size() ||
      std::fread(fin.data(), 4, n, f) != (size_t)n ||
      std::fread(alive.data(), 4, n, f) != (size_t)n ||
      std::fread(cnt, 8, 2, f) != 2)
    return 2;
  std::fclose(f);
  const int words = srt_film_sum_words(n);
  const int tiles = (n + 255) / 256;
  std::vector<int> meta(8 * (size_t)pixels, 0);
  std::vector<unsigned> bits((size_t)pixels * words, 0u);
  std::vector<int2> table((size_t)tiles * srt_film_sum_slots());
  std::vector<float> packed(3 * (size_t)n);
  unsigned barrier = 0;
  FilmSumArgs a{acc.data(), pix.data(), rad.data(), fin.data(), alive.data(),
                meta.data(), bits.data(), table.data(), packed.data(),
                &barrier, &cnt[0], &cnt[1], n, pixels, words};
  for (int r = 0; r < reps; ++r) {
    const int rc = srt_film_sum(&a, nullptr);
    if (rc) return 10 + rc;
  }
  for (int p = 0; p < pixels; ++p)
    if (meta[8 * (size_t)p]) return 3;
  for (unsigned b : bits)
    if (b) return 4;
  f = std::fopen("out.bin", "wb");
  std::fwrite(acc.data(), 4, acc.size(), f);
  std::fwrite(cnt, 8, 2, f);
  std::fclose(f);
  return 0;
}
"""

_SEGMENT_MAIN = r"""
#include <cstdio>
#include <vector>
#include "segment.cu"
// in.bin: int32 n, m, reps; float g (n, 10); int seg (n). out.bin: the
// (m, 14) table of the last of reps launches on one counter.
int main() {
  FILE* f = std::fopen("in.bin", "rb");
  int h[3];
  if (std::fread(h, 4, 3, f) != 3) return 2;
  const int n = h[0], m = h[1], reps = h[2];
  std::vector<float> g(10 * (size_t)n);
  std::vector<int> seg(n);
  if (std::fread(g.data(), 4, g.size(), f) != g.size() ||
      std::fread(seg.data(), 4, n, f) != (size_t)n) return 2;
  std::fclose(f);
  const int blocks = blocks_for(n);
  std::vector<float> part((size_t)blocks * m * 10), out((size_t)m * 14, -7.0f);
  unsigned done = 0;
  const int cols[10] = {1, 2, 3, 4, 6, 7, 8, 9, 10, 11};
  SegmentSumArgs a{g.data(), seg.data(), part.data(), out.data(), &done, n, 10, m, 14, {}};
  for (int c = 0; c < 10; ++c) a.col[c] = cols[c];
  for (int r = 0; r < reps; ++r) {
    std::fill(out.begin(), out.end(), -7.0f);
    const int rc = srt_segment_sum(&a, nullptr);
    if (rc) return 10 + rc;
  }
  if (done % (1u << 20)) return 3;
  f = std::fopen("out.bin", "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
  return 0;
}
"""

#: the material sum's kFill and kCombiners in the CPU build
FILL, COMBINERS = 2, 3


@pytest.fixture(scope="module")
def film_exe(tmp_path_factory):
    src, k1 = emulator.shared_on_host(emulator.source("film_sum.cu"))
    src, k2 = re.subn(
        r"cudaLaunchCooperativeKernel\(\s*\(const void\*\)film_sum_kernel, "
        r"dim3\(grid\), dim3\(kThreads\), params, 0,\s*"
        r"\(cudaStream_t\)stream\)",
        "srt_launch(dim3(grid), dim3(kThreads), 0, "
        "[&] { film_sum_kernel(a); })", src)
    assert (k1, k2) == (1, 1)
    work = tmp_path_factory.mktemp("film_source")
    return work, emulator.compile_source(
        work, "film", src, _FILM_MAIN,
        {"grid_barrier.cuh": emulator.source("grid_barrier.cuh")})


@pytest.fixture(scope="module")
def segment_exe(tmp_path_factory):
    assert tuple(MAT_GRAD_COLS) == (1, 2, 3, 4, 6, 7, 8, 9, 10, 11)
    src = emulator.source("segment_sum.cu")
    counts = []
    for pat, rep in (
            (r"__shared__ (\w+) (\w+);", r"\1& \2 = sim_shared<\1>();"),
            (r"extern __shared__ float (\w+)\[\];",
             r"float* \1 = (float*)sim_dynamic();"),
            (r"segment_sum_kernel<<<([^,]+), kThreads, smem,\s*"
             r"\(cudaStream_t\)stream>>>\(a, chunks_for\(a.n\)\);",
             r"srt_launch(dim3(\1), dim3(kThreads), smem, "
             r"[&] { segment_sum_kernel(a, chunks_for(a.n)); });"),
            (r"constexpr int kFill = 128;", f"constexpr int kFill = {FILL};"),
            (r"constexpr int kCombiners = 32;",
             f"constexpr int kCombiners = {COMBINERS};")):
        src, k = re.subn(pat, rep, src)
        counts.append(k)
    assert counts == [1] * 5
    work = tmp_path_factory.mktemp("segment_source")
    return work, emulator.compile_source(work, "segment", src, _SEGMENT_MAIN)


@pytest.mark.parametrize("layout,lanes,sms", [
    ("scattered", 5000, 4), ("records", 6000, 4), ("every-tile", 5000, 4),
    ("one-pixel", 3000, 4), ("straddle", 3000, 16), ("runs-1024", 4096, 16)])
def test_film_source_matches_plain(layout, lanes, sms, film_exe):
    work, exe = film_exe
    acc0, pix, rad, fin, alive = film_flush(layout, lanes=lanes)
    n, pixels = pix.shape[0], acc0.shape[1]
    with open(work / "in.bin", "wb") as f:
        f.write(np.array([n, pixels, 2], np.int32).tobytes())
        for x in (acc0, pix, rad, fin, alive):
            f.write(np.ascontiguousarray(x).tobytes())
        f.write(np.array([5, 7], np.int64).tobytes())
    rc = subprocess.run([exe], cwd=work, timeout=120, env=dict(
        os.environ, SIM_SMS=str(sms), SIM_PER_SM="1")).returncode
    assert rc == 0, f"the film's program exited {rc} (3, 4: scratch left)"
    out = np.fromfile(work / "out.bin", np.uint8)
    got = out[:12 * pixels].view(np.float32).reshape(3, pixels)
    want = [torch.from_numpy(acc0.copy()), torch.tensor(5), torch.tensor(7)]
    for _ in range(2):
        kfilm.film_sum_reference(*want, *(torch.from_numpy(x) for x in
                                          (pix, rad, fin, alive)))
    nan = np.isnan(got)
    assert np.array_equal(nan, np.isnan(want[0].numpy()))
    np.testing.assert_array_equal(np.where(nan, 0, got).view(np.int32),
                                  np.where(nan, 0, want[0].numpy())
                                  .view(np.int32))
    assert list(out[12 * pixels:].view(np.int64)) == [int(want[1]),
                                                      int(want[2])]


@pytest.mark.parametrize("n,m", [(300, 7), (4173, 124), (70000, 124)])
def test_segment_source_matches_its_order(n, m, segment_exe):
    work, exe = segment_exe
    r = np.random.default_rng(n)
    g = (r.standard_normal((n, 10))
         * 10.0 ** r.integers(-6, 3, (n, 1))).astype(np.float32)
    seg = r.integers(0, m, n).astype(np.int32)
    seg[: n // 2] = 7 % m
    with open(work / "in.bin", "wb") as f:
        f.write(np.array([n, m, 2], np.int32).tobytes())
        f.write(g.tobytes())
        f.write(seg.tobytes())
    rc = subprocess.run([exe], cwd=work, timeout=120).returncode
    assert rc == 0, f"the material sum's program exited {rc}"
    got = np.fromfile(work / "out.bin", np.float32).reshape(m, 14)
    want = kseg.material_sum_order(torch.from_numpy(g), torch.from_numpy(seg),
                                   m, fill=FILL).numpy()
    assert kseg.chunks_for(n, FILL) == {300: 1, 4173: 8, 70000: 8}[n]
    assert kseg.blocks_for(n, FILL) > 32 or n < 70000
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
