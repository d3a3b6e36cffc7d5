"""The sphere sweep split over a lane's threads (``csrc/bounce_core.cuh``).

Kernels B1 and B2 run each lane's sphere sweep on G threads, its shares:
share p tests spheres p, p + G, ...; the shares meet in ``nearest_share``
(the nearest t, the lowest index on a tie) and ``finish_hit`` runs the rect
sweep against their winner. B5 replays the same code. Here the header is
built with g++ (the CUDA qualifiers defined away by a stub
``cuda_runtime.h``) and run on the CPU: for G = 1, 2, 4 and 8 the combined
winner must be ``closest_hit``'s, the one-thread sweep, field for field and
bit for bit, on the staged records ``stage_tables`` lays out; and
``closest_hit``'s sphere must be the one the sphere table's formula gives,
one float32 operation at a time, with its bits.
"""
from __future__ import annotations

import os
import re
import subprocess

import numpy as np
import pytest
import torch

from srt_tpu_torch import get_scene
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import build
from srt_tpu_torch.scene.ir import SceneFlags

torch.set_num_threads(1)

SHARES = (1, 2, 4, 8)

# The CUDA names bounce_core.cuh uses, for a one-thread host build
_STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct Dim3 { unsigned x, y, z; };
inline Dim3 threadIdx{0, 0, 0}, blockDim{1, 1, 1};
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
template <class T> inline T __ldg(const T* p) { return *p; }
using std::max;
using std::min;
"""

# Reads "in.bin" (int32 n_sph, n_rect, n_rays, moving; float32 spheres
# (n_sph, 12), rects (n_rect, 10), rays (n_rays, 7): o, d, time) and
# writes "out.bin": for closest_hit, then each G of SHARES, per ray the
# int32 words t, u, v (bit patterns), sph, rect, material, hit.
_PROGRAM = r"""
#include <cstdio>
#include <vector>
#include "bounce_core.cuh"
using namespace srt;

template <bool kMoving>
Winner shared(const SceneView& s, V3 o, V3 d, float time, int G) {
  float t, t_q;
  int k, k_q;
  sphere_share<kMoving>(s, o, d, time, 0, G, t, k);
  for (int q = 1; q < G; ++q) {
    sphere_share<kMoving>(s, o, d, time, q, G, t_q, k_q);
    nearest_share(t_q, k_q, t, k);
  }
  return finish_hit(s, o, d, t, k);
}

void put(std::vector<int>& out, const Winner& W) {
  out.push_back(__float_as_int(W.t));
  out.push_back(__float_as_int(W.u));
  out.push_back(__float_as_int(W.v));
  out.push_back(W.sph);
  out.push_back(W.rect);
  out.push_back(W.m);
  out.push_back(W.hit);
}

template <bool kMoving>
void run(const SceneView& s, const float* rays, int n, std::vector<int>& out) {
  for (int i = 0; i < n; ++i) {
    const float* r = rays + 7 * i;
    put(out, closest_hit<kMoving>(s, v3(r[0], r[1], r[2]),
                                  v3(r[3], r[4], r[5]), r[6]));
  }
  for (int G : {SHARES})
    for (int i = 0; i < n; ++i) {
      const float* r = rays + 7 * i;
      put(out, shared<kMoving>(s, v3(r[0], r[1], r[2]),
                               v3(r[3], r[4], r[5]), r[6], G));
    }
}

int main() {
  FILE* f = std::fopen("in.bin", "rb");
  int h[4];
  if (std::fread(h, 4, 4, f) != 4) return 1;
  const int n_sph = h[0], n_rect = h[1], n = h[2];
  std::vector<float> sph(12 * n_sph + 1), rect(10 * n_rect + 1), rays(7 * n);
  if (std::fread(sph.data(), 4, 12 * n_sph, f) != (size_t)(12 * n_sph)
      || std::fread(rect.data(), 4, 10 * n_rect, f) != (size_t)(10 * n_rect)
      || std::fread(rays.data(), 4, 7 * n, f) != (size_t)(7 * n))
    return 1;
  std::fclose(f);
  std::vector<float4> smem(3 * n_sph + (10 * n_rect + 3) / 4 + 1);
  SceneView s{};
  s.n_sph = n_sph;
  s.n_rect = n_rect;
  stage_tables(s, reinterpret_cast<float*>(smem.data()), sph.data(),
               rect.data(), nullptr, nullptr);
  std::vector<int> out;
  if (h[3]) run<true>(s, rays.data(), n, out);
  else run<false>(s, rays.data(), n, out);
  f = std::fopen("out.bin", "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fclose(f);
}
"""

_FIELDS = ("t", "u", "v", "sph", "rect", "m", "hit")


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """A function ``(sph, rect, rays, moving) -> (closest_hit's winners,
    {G: the shares' winners})``, each an (n, 7) int32 array of
    ``_FIELDS``, from ``csrc/bounce_core.cuh`` built with g++."""
    work = tmp_path_factory.mktemp("sweep_shares")
    (work / "cuda_runtime.h").write_text(_STUB)
    (work / "sweep.cpp").write_text(
        _PROGRAM.replace("{SHARES}", "{" + ", ".join(map(str, SHARES)) + "}"))
    csrc = os.path.dirname(build.SOURCES[0])
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-I", str(work), "-I", csrc, "-o", str(work / "sweep"),
                    str(work / "sweep.cpp")], check=True)

    def run(sph, rect, rays, moving):
        sph, rect, rays = (np.ascontiguousarray(a, np.float32)
                           for a in (sph, rect, rays))
        head = np.array([len(sph), len(rect), len(rays), int(moving)],
                        np.int32)
        (work / "in.bin").write_bytes(head.tobytes() + sph.tobytes()
                                      + rect.tobytes() + rays.tobytes())
        subprocess.run([str(work / "sweep")], cwd=work, check=True)
        out = np.fromfile(work / "out.bin", np.int32).reshape(
            1 + len(SHARES), len(rays), len(_FIELDS))
        return out[0], dict(zip(SHARES, out[1:]))
    return run


def _rays(o, d, time=None) -> np.ndarray:
    o, d = np.asarray(o, np.float32), np.asarray(d, np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t = np.zeros(len(o), np.float32) if time is None else time
    return np.concatenate([o, d, np.asarray(t, np.float32)[:, None]], 1)


def _scene_tables(name: str):
    scene, cam, _ = get_scene(name, device="cpu")
    tb = kb.build_tables(scene, SceneFlags.of(scene))
    return scene, cam, tb["sph"].numpy(), tb["rect"].numpy()


def _random_rays(r, n, centre, spread) -> np.ndarray:
    o = np.asarray(centre, np.float32) + r.uniform(-spread, spread, (n, 3))
    return _rays(o, r.standard_normal((n, 3)), r.random(n))


def _sphere(centre, radius, mat=0, flip=1.0, env=0.0, delta=(0, 0, 0),
            t0=0.0, t1=1.0):
    return [*centre, *delta, t0, 1.0 / max(t1 - t0, 1e-20), radius, mat,
            flip, env]


def _formula(sph, rays, moving):
    """The sphere sweep as the (S, 12) table's formula, one float32
    operation at a time in the kernels' order (numpy contracts no
    multiply-add): the centre (lerped with the table's reciprocal when
    ``moving``), b, c with the radius squared, the discriminant, the near
    root else the far one beyond 1e-3, an env dome's far root; the first
    nearest. Returns each ray's (t, sphere index)."""
    f32, big = np.float32, np.float32(3e38)
    o, d, time = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    t_best = np.full(len(rays), big, f32)
    k_best = np.full(len(rays), -1)
    with np.errstate(all="ignore"):
        for k, r in enumerate(np.asarray(sph, f32)):
            c = r[None, 0:3]
            if moving:
                f = (time - r[6]) * r[7]
                c = np.stack([r[0] + f * r[3], r[1] + f * r[4],
                              r[2] + f * r[5]], 1)
            oc = o - c
            b = oc[:, 0] * d[:, 0] + oc[:, 1] * d[:, 1] + oc[:, 2] * d[:, 2]
            cc = (oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1]
                  + oc[:, 2] * oc[:, 2]) - r[8] * r[8]
            disc = b * b - cc
            sq = np.where(disc > 0, np.sqrt(np.maximum(disc, f32(0))), f32(0))
            t0, t1 = -b - sq, -b + sq
            tmin = f32(1e-3)
            if r[11] > 0:
                t = np.where(t1 > tmin, t1, big)
            else:
                t = np.where((disc > 0) & (t0 > tmin) & (t0 < big), t0,
                             np.where((disc > 0) & (t1 > tmin) & (t1 < big),
                                      t1, big))
            better = t < t_best
            t_best = np.where(better, t, t_best)
            k_best = np.where(better, k, k_best)
    return t_best, k_best


def _case(name: str):
    """(spheres, rects, rays, moving) of one case."""
    r = np.random.default_rng(7)
    if name == "ball_scenes":
        # the main path's scene: 122 spheres (an env dome among them), its
        # rects; camera rays through seeded film points and rays from
        # random points among the balls
        scene, cam, sph, rect = _scene_tables(name)
        s, t = (torch.from_numpy(r.random(512).astype(np.float32))
                for _ in range(2))
        o, d, _ = cam.rays(s, t, torch.full((512,), 0.5),
                           torch.full((512,), 0.5), torch.zeros(512))
        rays = np.concatenate([_rays(o.numpy(), d.numpy()),
                               _random_rays(r, 512, (0.0, 1.0, 0.0), 6.0)])
        return sph, rect, rays, False
    if name == "random_scene_moving":
        # 484 spheres, the small ones moving over the shutter interval
        scene, cam, sph, rect = _scene_tables("random_scene")
        assert (sph[:, 3:6] != 0).any()
        return sph, rect, _random_rays(r, 1024, (0.0, 1.0, 0.0), 11.0), True
    if name == "identical_spheres":
        # spheres 1 and 6, and 2 and 3, are the same sphere: the lower
        # index wins wherever it lands among the shares
        sph = [_sphere((x, 0.0, 8.0), 0.8, mat=k) for k, x in
               enumerate((-6.0, 0.0, 3.0, 3.0, -3.0, 6.0, 0.0, 9.0, -9.0))]
        sph[3][9] = 30.0
        sph[6][9] = 60.0
        o = np.zeros((128, 3), np.float32)
        d = np.stack([np.linspace(-9.5, 9.5, 128),
                      r.uniform(-0.05, 0.05, 128), np.full(128, 8.0)], 1)
        return np.array(sph), np.zeros((0, 10)), _rays(o, d), False
    if name == "rect_at_sphere_t":
        # a ray along +z meets the sphere at t = 4 and the rect z = 4 at
        # t = 4: the sphere keeps it; a rect nearer by one ulp wins
        sph = np.array([_sphere((0.0, 0.0, 5.0), 1.0, mat=1)] * 3)
        near = float(np.nextafter(np.float32(4.0), np.float32(0.0)))
        rect = np.array([[2, 0, 1, 4.0, -2, 2, -2, 2, 7, 1],
                         [2, 0, 1, near, 5, 6, 5, 6, 8, 1]], np.float32)
        o = np.array([[0, 0, 0]] * 2 + [[5.5, 5.5, 0]], np.float32)
        d = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1]], np.float32)
        rays = _rays(o, d)
        sph[1, :3] = (5.5, 5.5, 5.0)
        return sph, rect, rays, False
    if name == "env_dome":
        # rays inside an env dome (its far root; a second dome, the same,
        # loses the tie), past a flipped sphere; and rays from outside it
        # with no real root, which an env dome takes at -b where -b > t_min
        sph = np.array([_sphere((0.0, 0.0, 0.0), 50.0, mat=2, flip=-1.0,
                                env=1.0),
                        _sphere((0.0, 0.0, 12.0), 4.0, mat=1, flip=-1.0),
                        _sphere((0.0, 0.0, 0.0), 50.0, mat=2, env=1.0)])
        inside = _random_rays(r, 256, (0.0, 0.0, 0.0), 10.0)
        outside = _rays(np.tile([[0.0, 200.0, 0.0]], (64, 1)),
                        np.stack([np.ones(64), -np.linspace(0.0, 0.2, 64),
                                  np.zeros(64)], 1))
        return sph, np.zeros((0, 10)), np.concatenate([inside, outside]), \
            False
    raise KeyError(name)


@pytest.mark.parametrize("case", ["ball_scenes", "random_scene_moving",
                                  "identical_spheres", "rect_at_sphere_t",
                                  "env_dome"])
def test_shares_give_closest_hits_winner(case, sweep):
    """For G = 1, 2, 4, 8 the shares' combined winner is closest_hit's: t,
    u, v to the bit, the sphere, the rect, the material and the hit flag;
    closest_hit's sphere is the table formula's, and its t where a sphere
    wins, to the bit (the staged records and the skipped square root keep
    the one-thread test's operations); and the case reaches what it is
    for."""
    sph, rect, rays, moving = _case(case)
    rays = np.asarray(rays, np.float32)
    ref, shared = sweep(sph, rect, rays, moving)
    t_f, k_f = _formula(sph, rays, moving)
    assert (ref[:, 3] == k_f).all()
    won = ref[:, 4] < 0
    assert (ref[won, 0] == t_f.view(np.int32)[won]).all()
    for g, got in shared.items():
        bad = np.flatnonzero((got != ref).any(1))
        assert not len(bad), (
            f"G={g}: {len(bad)} of {len(rays)} rays differ, first ray "
            f"{bad[0]}: {dict(zip(_FIELDS, got[bad[0]]))} against "
            f"{dict(zip(_FIELDS, ref[bad[0]]))}")
    hit, k, rk = ref[:, 6] != 0, ref[:, 3], ref[:, 4]
    if case in ("ball_scenes", "random_scene_moving"):
        # many spheres win, and rects where the scene has them
        assert len(set(k[hit & (rk < 0)].tolist())) > 10
        assert (rk >= 0).any() == (len(rect) > 0)
    elif case == "identical_spheres":
        won = set(k[hit & (rk < 0)].tolist())
        assert {1, 2} <= won and not won & {3, 6}
    elif case == "rect_at_sphere_t":
        t = ref[:, 0].view(np.float32)
        assert t[0] == 4.0 and rk[0] == -1 and k[0] == 0 and ref[0, 5] == 1
        assert rk[2] == 1 and ref[2, 5] == 8
    elif case == "env_dome":
        inside = slice(0, 256)
        assert (k[inside] != 2).all() and (k[inside] == 0).any()
        assert (k[inside] == 1).any() and ref[256, 6] == 0
        assert (k[257:] == 0).all()


def test_dead_counts_follow_the_kernels_lanes_a_block():
    """B1's work-queue ranks read one dead count per block of the kernel's
    ``kLanes`` lanes (``csrc/regen_bounce.cu``): ``kernels/bounce.py``'s
    ``BLOCK`` is that constant, ``count_dead`` counts per ``BLOCK`` lanes,
    and the wrapper refuses a ``dead`` plane of another length."""
    src = next(s for s in build.SOURCES if s.endswith("regen_bounce.cu"))
    with open(src) as f:
        lanes = int(re.search(r"constexpr int kLanes = (\d+);",
                              f.read()).group(1))
    assert kb.BLOCK == lanes
    n = 3 * lanes + 17
    alive = torch.from_numpy(np.random.default_rng(3).random(n) < 0.6).int()
    dead = kb.count_dead(alive)
    want = [int((alive[b * lanes:(b + 1) * lanes] == 0).sum())
            for b in range(4)]
    assert dead.tolist() == want
    scene, cam = _scene_tables("ball_scenes")[:2]
    inp = kb.RegenInputs(scene, SceneFlags.of(scene), cam,
                         torch.zeros((1, 2)))
    st = kb.new_wavefront(n, "cpu")
    assert st["dead"].shape == (4,)
    spec = kb.RegenSpec(width=8, height=8, spp=1, max_depth=2, rr_start=2,
                        pdf_floor=1e-9, seed=0)
    kb.regen_args(inp, st, spec)
    st["dead"] = st["dead_next"] = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="one count per block"):
        kb.regen_args(inp, st, spec)
