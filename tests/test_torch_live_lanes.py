"""B5's list of live lanes (``csrc/live_lanes.cuh``), run on the CPU.

The header is built with g++ through ``tests/_cuda_emulator.py`` (every
CUDA thread a host thread, every block of the grid at once, so its grid
barrier meets as on the card) beneath a kernel that calls
``list_live`` and then ``pass_dead`` (its runs drawn from a counter), and
is launched twice on one barrier, as two launches of B5 would. On each
layout of the alive plane the list must be ``torch.nonzero(alive)`` in
lane order and its length the live lanes, in every block and in the
tracer's counter; each dead lane's rows must be its cotangents to the bit,
its material row and id 0; and nothing of a live lane, nor of the list
past its length, may be written. The layouts: all dead, all live, one
live lane first or last, 1%, 5% and 50% at random, runs like the scan
wavefront's, fewer lanes than the grid's warps, and lane counts that are
not a multiple of 32 or of a block's share.
"""
from __future__ import annotations

import subprocess

import _cuda_emulator as emulator
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

_KERNEL = r"""
#include "live_lanes.cuh"
using namespace srt::live;
__global__ void lanes_kernel(Lanes a, PassThrough p, int* totals, int* next) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *next = 0;
  const int total = list_live(a);
  pass_dead(a, p, next);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}
"""

_MAIN = r"""
#include <cstdio>
#include <vector>
#include "live.cu"
// in.bin: int32 n, grid, threads, reps; uint8 alive (n); float ct (4, n, 3).
// out.bin: int32 totals (grid), list (n); float g (4, n, 3), mat (n, 10);
// int32 id (n); uint32 barrier; int64 live. The outputs start as
// sentinels (-1 and NaN bits 0x7fc0dead) that a live lane keeps.
int main() {
  FILE* f = std::fopen("in.bin", "rb");
  int h[4];
  if (std::fread(h, 4, 4, f) != 4) return 2;
  const int n = h[0], grid = h[1], threads = h[2], reps = h[3];
  std::vector<unsigned char> alive(n);
  std::vector<float> ct(12 * (size_t)n), g(12 * (size_t)n),
      mat(10 * (size_t)n);
  if (std::fread(alive.data(), 1, n, f) != (size_t)n ||
      std::fread(ct.data(), 4, ct.size(), f) != ct.size())
    return 2;
  std::fclose(f);
  const unsigned nan_bits = 0x7fc0deadu;
  float sentinel;
  std::memcpy(&sentinel, &nan_bits, 4);
  std::fill(g.begin(), g.end(), sentinel);
  std::fill(mat.begin(), mat.end(), sentinel);
  std::vector<int> totals(grid, -1), list(n, -1), id(n, -1);
  std::vector<int> counts(kMaxBlocks, -1);
  unsigned barrier = 0;
  int next = -1;
  long long live = 0;
  PassThrough p;
  for (int r = 0; r < 4; ++r) {
    p.src[r] = ct.data() + 3 * (size_t)n * r;
    p.dst[r] = g.data() + 3 * (size_t)n * r;
  }
  p.mat = mat.data();
  p.id = id.data();
  const Lanes a{alive.data(), n, list.data(), counts.data(), &barrier, &live};
  for (int r = 0; r < reps; ++r)
    srt_launch(dim3(grid), dim3(threads), 0,
               [&] { lanes_kernel(a, p, totals.data(), &next); });
  f = std::fopen("out.bin", "wb");
  std::fwrite(totals.data(), 4, grid, f);
  std::fwrite(list.data(), 4, n, f);
  std::fwrite(g.data(), 4, g.size(), f);
  std::fwrite(mat.data(), 4, mat.size(), f);
  std::fwrite(id.data(), 4, n, f);
  std::fwrite(&barrier, 4, 1, f);
  std::fwrite(&live, 8, 1, f);
  std::fclose(f);
  return 0;
}
"""

SENTINEL = np.uint32(0x7FC0DEAD)
REPS = 2


@pytest.fixture(scope="module")
def live_exe(tmp_path_factory):
    header, k = emulator.shared_on_host(emulator.source("live_lanes.cuh"))
    assert k == 2
    work = tmp_path_factory.mktemp("live_lanes")
    return work, emulator.compile_source(
        work, "live", _KERNEL, _MAIN,
        {"live_lanes.cuh": header,
         "grid_barrier.cuh": emulator.source("grid_barrier.cuh")})


def _alive(layout: str, n: int, r) -> np.ndarray:
    alive = np.zeros(n, bool)
    if layout == "live":
        alive[:] = True
    elif layout == "first":
        alive[0] = True
    elif layout == "last":
        alive[-1] = True
    elif layout.endswith("%"):
        alive = r.random(n) < float(layout[:-1]) / 100
    elif layout == "runs":
        # alternating dead and live runs, about a tenth live, as the scan
        # wavefront's pixels die a few samples at a time
        at, on = 0, False
        while at < n:
            run = int(r.geometric(1 / (8 if on else 72)))
            alive[at:at + run] = on
            at, on = at + run, not on
    return alive


@pytest.mark.parametrize("layout,n,grid,threads", [
    ("dead", 3001, 5, 64), ("live", 3001, 5, 64), ("first", 3001, 5, 64),
    ("last", 3001, 5, 64), ("1%", 4099, 7, 64), ("5%", 4099, 7, 192),
    ("50%", 4099, 3, 192), ("runs", 5000, 7, 64), ("runs", 4096, 4, 192),
    ("50%", 40, 5, 64)])
def test_live_list_matches_nonzero(layout, n, grid, threads, live_exe):
    work, exe = live_exe
    r = np.random.default_rng(n + grid)
    alive = _alive(layout, n, r)
    ct = r.standard_normal((4, n, 3)).astype(np.float32)
    ct[:, ::7] *= -0.0          # signed zeros pass through as they are
    with open(work / "in.bin", "wb") as f:
        f.write(np.array([n, grid, threads, REPS], np.int32).tobytes())
        f.write(alive.astype(np.uint8).tobytes())
        f.write(ct.tobytes())
    rc = subprocess.run([exe], cwd=work, timeout=120).returncode
    assert rc == 0, f"the list's program exited {rc}"
    out = np.fromfile(work / "out.bin", np.uint8)
    parts, at = [], 0
    for count, dtype in ((grid, np.int32), (n, np.int32), (12 * n, np.uint32),
                         (10 * n, np.uint32), (n, np.int32), (1, np.uint32),
                         (1, np.int64)):
        size = count * np.dtype(dtype).itemsize
        parts.append(out[at:at + size].view(dtype))
        at += size
    assert at == out.size
    totals, got, g, mat, ids, (barrier,), (live,) = parts

    want = torch.nonzero(torch.from_numpy(alive)).flatten().numpy()
    assert (totals == want.size).all()
    np.testing.assert_array_equal(got[:want.size], want)
    assert (got[want.size:] == -1).all()
    assert live == REPS * want.size
    assert barrier == REPS << 20          # one meeting a launch

    dead = ~alive
    g = g.reshape(4, n, 3)
    np.testing.assert_array_equal(g[:, dead], ct.view(np.uint32)[:, dead])
    assert (g[:, alive] == SENTINEL).all()
    mat = mat.reshape(n, 10)
    assert (mat[dead] == 0).all() and (mat[alive] == SENTINEL).all()
    assert (ids[dead] == 0).all() and (ids[alive] == -1).all()
