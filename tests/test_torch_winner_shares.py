"""Kernel B6's sweep split over each ray's threads (``csrc/sphere_winner.cu``).

B6 runs each ray's sphere sweep on G threads, its shares: share p tests
spheres p, p + G, ... with ``bounce_core.cuh:sphere_share`` beyond the
launch's ``t_min``, and share 0 folds the others' winners into its own in
the order q = 1 ... G - 1 with ``nearest_share`` (the nearest t, the
lowest index on a tie), as B2 folds its shares. Here the header is built
with g++ through the stub of ``tests/test_torch_sweep_shares.py`` and the
shares are run one after another: for G = 1, 2, 4 and 8 the folded
winner must be the plain version's (``render/intersect.py:sphere_winner``),
``t`` to the bit and the index, on ball_scenes, random_scene's moving
spheres and spheres that tie exactly, at ``t_min`` 1e-3 and at larger
ones.

The plain version's square root is taken here in float64 and rounded once
to float32, which is the correctly rounded float32 root, as the card's
``sqrtf`` and torch's CUDA ``sqrt`` give it: torch's CPU ``sqrt`` is not
correctly rounded in every case (on ball_scenes' 10,000-radius sphere it
returns 9984.8251953125 for the root of 99696744, whose nearest float32 is
9984.826171875).
"""
from __future__ import annotations

import os
import subprocess
import warnings

import numpy as np
import pytest
import torch
from test_torch_sweep_shares import _STUB

from srt_tpu_torch import get_scene
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import build
from srt_tpu_torch.render import intersect as ri
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import SceneFlags

torch.set_num_threads(1)

SHARES = (1, 2, 4, 8)

# Reads "in.bin" (int32 n_sph, n_rays; float32 t_min, spheres (n_sph, 12),
# rays (n_rays, 7): o, d, time) and writes "out.bin": for each G of
# SHARES, per ray the int32 words t (bit pattern) and idx.
_PROGRAM = r"""
#include <cstdio>
#include <vector>
#include "bounce_core.cuh"
using namespace srt;

// csrc/sphere_winner.cu's sweep for one ray on G threads: each share,
// then share 0 folding shares 1 ... G - 1 into its winner
void winner(const SceneView& s, V3 o, V3 d, float time, float t_min, int G,
            std::vector<int>& out) {
  float t[8];
  int k[8];
  for (int p = 0; p < G; ++p)
    sphere_share<true>(s, o, d, time, p, G, t[p], k[p], t_min);
  for (int q = 1; q < G; ++q) nearest_share(t[q], k[q], t[0], k[0]);
  out.push_back(__float_as_int(t[0]));
  out.push_back(k[0]);
}

int main() {
  FILE* f = std::fopen("in.bin", "rb");
  int h[2];
  float t_min;
  if (std::fread(h, 4, 2, f) != 2 || std::fread(&t_min, 4, 1, f) != 1)
    return 1;
  const int n_sph = h[0], n = h[1];
  std::vector<float> sph(12 * n_sph), rays(7 * n);
  if (std::fread(sph.data(), 4, 12 * n_sph, f) != (size_t)(12 * n_sph)
      || std::fread(rays.data(), 4, 7 * n, f) != (size_t)(7 * n))
    return 1;
  std::fclose(f);
  std::vector<float4> staged(3 * n_sph);
  stage_spheres(staged.data(), sph.data(), n_sph);
  SceneView s{};
  s.sph = staged.data();
  s.n_sph = n_sph;
  std::vector<int> out;
  for (int G : {SHARES})
    for (int i = 0; i < n; ++i) {
      const float* r = rays.data() + 7 * i;
      winner(s, v3(r[0], r[1], r[2]), v3(r[3], r[4], r[5]), r[6], t_min, G,
             out);
    }
  f = std::fopen("out.bin", "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
}
"""


@pytest.fixture(scope="module")
def shares(tmp_path_factory):
    """A function ``(sph, rays, t_min) -> {G: (t, idx)}`` from
    ``csrc/bounce_core.cuh`` built with g++, ``t`` float32."""
    work = tmp_path_factory.mktemp("winner_shares")
    (work / "cuda_runtime.h").write_text(_STUB)
    (work / "winner.cpp").write_text(
        _PROGRAM.replace("{SHARES}", "{" + ", ".join(map(str, SHARES)) + "}"))
    csrc = os.path.dirname(build.SOURCES[0])
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-I", str(work), "-I", csrc, "-o", str(work / "winner"),
                    str(work / "winner.cpp")], check=True)

    def run(sph, rays, t_min):
        sph, rays = (np.ascontiguousarray(a, np.float32) for a in (sph, rays))
        head = np.array([len(sph), len(rays)], np.int32).tobytes()
        (work / "in.bin").write_bytes(head + np.float32(t_min).tobytes()
                                      + sph.tobytes() + rays.tobytes())
        subprocess.run([str(work / "winner")], cwd=work, check=True)
        out = np.fromfile(work / "out.bin", np.int32).reshape(
            len(SHARES), len(rays), 2)
        return {g: (o[:, 0].view(np.float32), o[:, 1])
                for g, o in zip(SHARES, out)}
    return run


def _rounded_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``safe_sqrt`` correctly rounded: the float64 root, rounded once."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0).double())
                       .float(), 0.0)


def _plain_winner(scene, o, d, time, t_min=1e-3):
    """``render/intersect.py:sphere_winner`` on numpy rays, its square root
    correctly rounded; numpy ``(t, idx)``."""
    sqrt = ri.safe_sqrt
    ri.safe_sqrt = _rounded_sqrt
    try:
        t, idx = ri.sphere_winner(
            scene, *(torch.from_numpy(x) for x in (o, d, time)), t_min)
    finally:
        ri.safe_sqrt = sqrt
    return t.numpy(), idx.numpy()


def _random_rays(r, n, lo, hi):
    """``n`` rays from uniform points of the box (lo, hi), directions and
    times seeded."""
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, r.random(n).astype(np.float32)


def _ties(r):
    """Nine balls on a line, of which spheres 1 and 6, and 2 and 3, are
    the same sphere, so equal t lands on different shares at every G > 1;
    rays from the origin across the line."""
    b = SceneBuilder()
    m = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    for x in (-6.0, 0.0, 3.0, 3.0, -3.0, 6.0, 0.0, 9.0, -9.0):
        b.sphere((x, 0.0, 8.0), 0.8, m)
    o = np.zeros((256, 3), np.float32)
    d = np.stack([np.linspace(-9.5, 9.5, 256), r.uniform(-0.05, 0.05, 256),
                  np.full(256, 8.0)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return b.build("cpu"), (o, d, np.zeros(256, np.float32))


def _case(name: str):
    """(scene, (o, d, time)) of one case."""
    r = np.random.default_rng(5)
    if name == "ties":
        return _ties(r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene(name, device="cpu")
    if name == "random_scene":
        # 484 spheres, the small ones moving over the shutter interval
        assert bool((scene.sph_center1 != scene.sph_center0).any())
        return scene, _random_rays(r, 1024, (-11.0, -10.0, -11.0),
                                   (11.0, 12.0, 11.0))
    # ball_scenes, the train path's scene: camera rays through seeded
    # film points and rays from random points among its 20-radius balls
    s, t = (torch.from_numpy(r.random(384).astype(np.float32))
            for _ in range(2))
    o, d, _ = cam.rays(s, t, torch.full((384,), 0.5),
                       torch.full((384,), 0.5), torch.zeros(384))
    near = _random_rays(r, 640, (50.0, 0.0, -50.0), (550.0, 40.0, 450.0))
    return scene, (np.concatenate([o.numpy(), near[0]]),
                   np.concatenate([d.numpy(), near[1]]),
                   np.concatenate([np.zeros(384, np.float32), near[2]]))


@pytest.mark.parametrize("case,t_min", [
    ("ball_scenes", 1e-3), ("ball_scenes", 25.0), ("random_scene", 1e-3),
    ("random_scene", 2.0), ("ties", 1e-3), ("ties", 7.5)])
def test_split_sweep_gives_the_plain_winner(case, t_min, shares):
    """At every G the folded winner is the plain version's: ``t`` to the
    bit and the index (-1 and 3e38 on a miss); and the case
    reaches what it is for: many winners, misses, the lower of two equal
    spheres, a ``t_min`` that changes hits."""
    scene, (o, d, time) = _case(case)
    sph = kb.build_tables(scene, SceneFlags.of(scene))["sph"].numpy()
    pt, pidx = _plain_winner(scene, o, d, time, t_min)
    rays = np.concatenate([o, d, time[:, None]], 1)
    for g, (t, idx) in shares(sph, rays, t_min).items():
        bad = np.flatnonzero((idx != pidx) | (t.view(np.int32)
                                              != pt.view(np.int32)))
        assert not len(bad), (
            f"G={g}: {len(bad)} of {len(o)} rays differ, first ray "
            f"{bad[0]}: ({t[bad[0]]}, {idx[bad[0]]}) against "
            f"({pt[bad[0]]}, {pidx[bad[0]]})")
    won = set(pidx[pidx >= 0].tolist())
    assert (pidx < 0).any() or case == "ball_scenes"   # the dome holds all
    assert (pt[pidx < 0] == np.float32(3e38)).all()
    if case == "ties":
        assert {1, 2} <= won and not won & {3, 6}
    else:
        assert len(won) > 10
    if t_min > 1e-3:
        assert (_plain_winner(scene, o, d, time)[0] != pt).any()
