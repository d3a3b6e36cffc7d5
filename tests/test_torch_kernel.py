"""The CUDA kernels (srt_tpu_torch/csrc/): the regeneration bounce
(``regen_bounce.cu``), the per-bounce step (``bounce.cu``, the train
forward, and with a triangle hit the bounce of triangle scenes), its VJP,
the train backward (``bounce_bwd.cu``), the triangle BVH walks, single
level (``intersect_tris.cu``) and two level (``intersect_big.cu``), the
sphere winner of the hybrid backward (``sphere_winner.cu``), the film sum
(``film_sum.cu``) and the material sum (``segment_sum.cu``).

On a machine with an NVIDIA GPU the ``cuda``-marked tests build the
kernels and hold one launch of each against its plain version lane by
lane (B5 also on wavefronts of every share of live lanes, a dead lane's
rows to the bit); here, without a card, they skip. The CPU tests check that the
wrappers take the plain versions for CPU tensors without launching
anything, and what the build is asked to do.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import warnings

import numpy as np
import pytest
import torch
from _torch_flushes import FILM_LAYOUTS, film_flush
from _torch_scenes import (LIT_ROOM_CAMERA, clustered_soup, lit_room,
                          lit_room_media)

from srt_tpu_torch import get_scene
from srt_tpu_torch.core.sobol import sobol_points
from srt_tpu_torch.diff.inverse import camera_rays
from srt_tpu_torch import trace as tracer
from srt_tpu_torch.kernels import launch_counts
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.kernels import build
from srt_tpu_torch.kernels import film as kfilm
from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.kernels import segment as kseg
from srt_tpu_torch.kernels import spheres as ks
from srt_tpu_torch.render.camera import Camera
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import SceneFlags
from srt_tpu_torch.utils import cache, contract

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _scene(name, device):
    if name in ("lit_room", "lit_room_media"):
        fill = lit_room if name == "lit_room" else lit_room_media
        return (fill(SceneBuilder()).build(device),
                Camera.look_at(**LIT_ROOM_CAMERA, device=device))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene(name, device=device)
    return scene, cam


def _inputs(device, n=4096, cursor=2048, name="ball_scenes"):
    scene, cam = _scene(name, device)
    spec = kb.RegenSpec(width=64, height=64, spp=4, max_depth=8,
                        rr_start=2, pdf_floor=1e-9, seed=1)
    inp = kb.RegenInputs(scene, SceneFlags.of(scene), cam,
                         torch.from_numpy(sobol_points(4, 2)
                                          .astype(np.float32)))
    st = kb.new_wavefront(n, device)
    st["cursor"].fill_(cursor)
    return inp, st, spec


@pytest.mark.parametrize("name,rich,perlin", [
    ("ball_scenes", 0, 0), ("random_scene", 1, 0),
    ("two_perlin_spheres", 1, 1), ("lit_room_media", 1, 0)])
def test_launch_arguments_pick_the_instantiation(name, rich, perlin):
    """B1's launch arguments, built on the CPU: the lean instantiation for
    ball_scenes (no rich field set), the rich one for the analytic
    library's families, with the Perlin tables staged only for a noise
    texture; the tables' fields are fixed once for the render."""
    inp, st, spec = _inputs("cpu", n=300, name=name)
    args = kb.regen_args(inp, st, spec)
    assert (args.rich, args.perlin, inp.rich) == (rich, perlin, bool(rich))
    assert bool(args.light_kind) == bool(rich) == bool(args.perlin_vec)
    assert args.n_med == inp.scene.n_media * rich
    assert args.sph == inp.tables["sph"].data_ptr() and args.n == 300
    assert args.moving == int(inp.flags.moving)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setitem(tracer.COUNTS, "B1", 0)
    inp, st, spec = _inputs("cpu", n=300)
    ref = {k: v.clone() for k, v in st.items()}
    kb.regen_bounce(inp, st, spec)
    kb.regen_bounce_reference(inp, ref, spec)
    assert launch_counts()["B1"] == 0
    for k in ("o", "d", "beta", "radiance", "salt", "pix", "depth", "alive",
              "fin", "dead", "cursor"):
        assert torch.equal(st[k], ref[k]), k
    # 300 lanes = two full blocks of kb.BLOCK = 128 lanes and one of 44;
    # all lanes were dead
    assert int(ref["cursor"][0]) == 2048 + 300
    assert kb.BLOCK == 128
    assert ref["dead"].tolist() == [int((ref["alive"][:128] == 0).sum()),
                                    int((ref["alive"][128:256] == 0).sum()),
                                    int((ref["alive"][256:] == 0).sum())]


def _train_inputs(device, n, name="ball_scenes", bounces=2):
    """A mid-flight state of the train engine: ``render_pixels``' camera
    rays (64x64, 4 spp) in a seeded order, ``bounces`` plain bounces with
    the depth cap, a seeded half of the lanes dead; and a seeded cotangent,
    zero on o, d, beta where the step ends the path (the engine never
    reads them again, and the kernels leave them as they were)."""
    scene, cam = _scene(name, device)
    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=50)
    r = np.random.default_rng(5)
    pix = torch.from_numpy(r.integers(0, 64 * 64, n)).to(device)
    (o, d, t), salt = camera_rays(cam, pix, 1, width=64, height=64, seed=3)
    st = dict(o=o, d=d, time=t, beta=torch.ones_like(o),
              radiance=torch.zeros_like(o), salt=salt,
              alive=torch.ones(n, dtype=torch.bool, device=device),
              depth=torch.zeros(n, dtype=torch.int32, device=device))
    with torch.no_grad():
        for _ in range(bounces):
            st = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    half = torch.from_numpy(r.random(n) < 0.5).to(device)
    st = {k: v.contiguous() for k, v in st.items()}
    st["alive"] = (st["alive"] & (st["depth"] < spec.max_depth) & ~half)
    with torch.no_grad():
        ends = ~kb.bounce_step_ref(scene, flags, tables["mat"], st,
                                   spec)["alive"]
    ct = {k: torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32))
          .to(device) for k in kbb.ROWS}
    for k in ("o", "d", "beta"):
        ct[k][ends] = 0.0
    return scene, flags, tables, st, spec, ct


def test_build_targets_sm90a_without_fast_math():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    for src in ("regen_bounce.cu", "bounce.cu", "bounce_bwd.cu",
                "intersect_tris.cu", "sphere_winner.cu"):
        assert any(s.endswith("/" + src) for s in build.SOURCES), src
    for h in ("bounce_core.cuh", "tri_bvh.cuh"):
        assert any(s.endswith("/" + h) for s in build.HEADERS), h
    assert "srt_intersect_tris" in build.ENTRY_POINTS
    assert "srt_sphere_winner" in build.ENTRY_POINTS
    assert build.library_path().startswith(cache.build_dir())


def test_library_name_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edit to the header the three kernels include names a new
    library, so a stale build is never loaded."""
    header = tmp_path / "bounce_core.cuh"
    shutil.copy(next(h for h in build.HEADERS
                     if h.endswith("bounce_core.cuh")), header)
    monkeypatch.setattr(build, "HEADERS", [str(header)])
    before = build.library_path()
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path() != before


# Dumps B5's column map as compiled: per instantiation a line "I rich K P
# columns", then for each pass p each slot of lane 1 it writes, as "W p
# row index value" (rows 0-2 o, d, beta, (n, 3); row 3 the material row,
# (n, 10)). Column j is written as j + 1, what no column feeds as 0.
_COLUMN_MAP_DUMP = r"""
#include <cmath>
#include <cstdio>
#include "bwd_columns.cuh"
using namespace srt::bwd;
template <bool R> void dump() {
  constexpr int K = kWidth<R>, P = kPasses<K, R>;
  std::printf("I %d %d %d %d\n", (int)R, K, P, kCols<R>);
  for (int p = 0; p < P; ++p) {
    float rows[4][40];
    for (auto& r : rows) for (float& x : r) x = NAN;
    float c[K];
    for (int k = 0; k < K; ++k) c[k] = (float)(p * K + k + 1);
    store_pass<K, R>(Grads{rows[0], rows[1], rows[2], rows[3]}, 1, p, c);
    if (p == 0) store_unfed<R>(rows[3], 1);
    for (int r = 0; r < 4; ++r)
      for (int e = 0; e < 40; ++e)
        if (!std::isnan(rows[r][e]))
          std::printf("W %d %d %d %g\n", p, r, e, rows[r][e]);
  }
}
int main() { dump<false>(); dump<true>(); }
"""


@pytest.fixture(scope="module")
def column_map(tmp_path_factory):
    """``csrc/bwd_columns.cuh`` built with g++ and run: per instantiation
    ``(K, P, columns, [(pass, row, entry in lane 1's row, value)])``."""
    work = tmp_path_factory.mktemp("bwd_columns")
    (work / "dump.cpp").write_text(_COLUMN_MAP_DUMP)
    csrc = os.path.dirname(build.SOURCES[0])
    subprocess.run(["g++", "-std=c++17", "-I", csrc, "-o", str(work / "dump"),
                    str(work / "dump.cpp")], check=True)
    out = subprocess.run([str(work / "dump")], check=True,
                         capture_output=True, text=True).stdout
    got = {}
    for kind, *f in map(str.split, out.splitlines()):
        if kind == "I":
            rich = bool(int(f[0]))
            got[rich] = (int(f[1]), int(f[2]), int(f[3]), [])
        else:
            p, r, e = map(int, f[:3])
            got[rich][3].append((p, r, e - (10 if r == 3 else 3),
                                 float(f[3])))
    return got


@pytest.mark.parametrize("rich", [False, True])
def test_bwd_passes_cover_every_column_once(rich, column_map):
    """B5's thread ``(lane, p)`` stores the columns p*K .. p*K + K - 1 of
    its lane, as ``csrc/bwd_columns.cuh`` compiles them (here with g++):
    the passes cover the 14 (lean) or 17 (rich) Jacobian columns once
    each, in ``ceil(columns / K)`` passes. Column j goes where the
    single-thread kernel put it: o, d and beta, then parameters 0-1, the
    colour and the second colour to entries 0-1, 4-6 and 7-9 of the
    per-lane material row (fields 1-2, 6-8 and 9-11 of the (M, 14) table).
    Pass 0 zeroes what no column feeds, so each of the lane's 19 outputs
    is written once."""
    k, p, n, writes = column_map[rich]
    assert n == (17 if rich else 14)
    assert p == -(-n // k)
    slots = ([(r, e) for r in range(3) for e in range(3)]
             + [(3, e) for e in (0, 1, 4, 5, 6, 7, 8, 9)])
    cols = sorted((int(v) - 1, q, r, e) for q, r, e, v in writes if v)
    assert cols == [(j, j // k, *slots[j]) for j in range(n)]
    unfed = sorted((q, r, e) for q, r, e, v in writes if not v)
    assert unfed == [(0, 3, 2), (0, 3, 3)] + (
        [] if rich else [(0, 3, 7), (0, 3, 8), (0, 3, 9)])
    written = sorted((r, e) for _, r, e, _ in writes)
    assert written == [(r, e) for r in range(3) for e in range(3)] + [
        (3, e) for e in range(10)]
    assert [kb.MAT_GRAD_COLS[e] for r, e in slots[9:n]] == (
        [1, 2, 6, 7, 8] + ([9, 10, 11] if rich else []))


def test_train_wrappers_take_the_plain_version(monkeypatch):
    """On CPU tensors the forward and backward wrappers are the plain step
    and ``torch.autograd`` of it, and launch nothing."""
    monkeypatch.setitem(tracer.COUNTS, "B2", 0)
    monkeypatch.setitem(tracer.COUNTS, "B5", 0)
    scene, flags, tables, st, spec, ct = _train_inputs("cpu", 300,
                                                       "lit_room")
    out = kb.bounce_fwd(scene, flags, tables, st, spec)
    with torch.no_grad():
        ref = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    for k in ("o", "d", "beta", "radiance", "depth", "alive"):
        assert torch.equal(out[k], ref[k]), k
    g, d_mat = kbb.bounce_bwd(scene, flags, tables, st, ct, spec)
    g_ref, d_mat_ref = kbb.bounce_bwd_reference(scene, flags, tables["mat"],
                                                st, ct, spec)
    for k in kbb.ROWS:
        assert torch.equal(g[k], g_ref[k]), k
    assert torch.equal(d_mat, d_mat_ref)
    assert d_mat.shape == (scene.mat_type.shape[0], 14)
    assert launch_counts()["B2"] == 0 and launch_counts()["B5"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ball_scenes", "lit_room", "random_scene",
                                  "two_perlin_spheres", "earth_sphere",
                                  "two_spheres", "lit_room_media"])
def test_kernel_matches_plain_on_gpu(name, cuda_device):
    """One launch against the plain version, roulette on (from depth 2),
    20,000 lanes (a partial last block); the scenes after the first two
    take the rich instantiation (image albedo multiplies the throughput
    before roulette in both)."""
    inp, st, spec = _inputs(cuda_device, n=20000, name=name)
    for _ in range(3):
        kb.regen_bounce_reference(inp, st, spec)
    st_k = {k: v.clone() for k, v in st.items()}
    launches = launch_counts()["B1"]
    kb.regen_bounce(inp, st_k, spec)
    kb.regen_bounce_reference(inp, st, spec)
    torch.cuda.synchronize()
    assert launch_counts()["B1"] == launches + 1
    for k in ("salt", "pix", "depth", "cursor"):
        assert torch.equal(st_k[k], st[k]), k
    contract.check_bounce(contract.wavefront_arrays(st),
                          contract.wavefront_arrays(st_k))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_scene", "lit_room_media"])
def test_rich_bounce_matches_plain_on_gpu(name, cuda_device):
    """B2's rich instantiation without triangles (the specular branch,
    media, textures) against the plain step, 20,000 lanes."""
    scene, flags, tables, st, spec, _ = _train_inputs(cuda_device, 20000,
                                                      name)
    launches = launch_counts()["B2"]
    out = kb.bounce_fwd(scene, flags, tables, st, spec)
    ref = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    torch.cuda.synchronize()
    assert launch_counts()["B2"] == launches + 1
    assert torch.equal(out["depth"], ref["depth"])
    keys = ("alive", "d", "beta", "radiance")
    contract.check_bounce({k: ref[k].cpu().numpy() for k in keys},
                          {k: out[k].cpu().numpy() for k in keys})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ball_scenes", "lit_room", "two_spheres",
                                  "two_perlin_spheres", "earth_sphere",
                                  "lit_room_media"])
def test_train_kernels_match_plain_on_gpu(name, cuda_device):
    """One launch of the train forward (B2) against the plain step, and of
    the train backward (B5) against ``torch.autograd`` of it, on 20,000
    mid-flight lanes (a partial last block): depth exact, the state under
    the per-bounce contract, the state cotangents under the gradient
    contract, and the (M, 14) segment sums within GRAD_RTOL plus 1e-4 of
    their largest entry (``index_add_`` on CUDA floats is atomic, so the
    sums' last bits change from run to run). The scenes after the first
    two take both kernels' rich instantiations; earth_sphere's state is
    its camera rays, since after a bounce nearly every path has left its
    two spheres."""
    scene, flags, tables, st, spec, ct = _train_inputs(
        cuda_device, 20000, name, 0 if name == "earth_sphere" else 2)
    fwd, bwd = launch_counts()["B2"], launch_counts()["B5"]
    rich = launch_counts()["B5 rich"]
    out = kb.bounce_fwd(scene, flags, tables, st, spec)
    ref = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    torch.cuda.synchronize()
    assert launch_counts()["B2"] == fwd + 1
    assert torch.equal(out["depth"], ref["depth"])

    def arrays(s):
        return {k: s[k].cpu().numpy() for k in ("alive", "d", "beta",
                                                "radiance")}
    contract.check_bounce(arrays(ref), arrays(out))

    g, d_mat = kbb.bounce_bwd(scene, flags, tables, st, ct, spec)
    g_ref, d_mat_ref = kbb.bounce_bwd_reference(scene, flags, tables["mat"],
                                                st, ct, spec)
    torch.cuda.synchronize()
    assert launch_counts()["B5"] == bwd + 1
    assert launch_counts()["B5 rich"] == rich + (
        name not in ("ball_scenes", "lit_room"))
    contract.check_grads({k: g_ref[k].cpu().numpy() for k in kbb.ROWS},
                         {k: g[k].cpu().numpy() for k in kbb.ROWS})
    a, b = d_mat_ref.cpu().numpy(), d_mat.cpu().numpy()
    assert np.abs(a).max() > 0.0
    np.testing.assert_allclose(b, a, rtol=contract.GRAD_RTOL,
                               atol=1e-4 * np.abs(a).max())


def _b5_inputs(device, n, rich, layout):
    """Camera rays of ``n`` lanes (B5's lean scene, ball_scenes, or a rich
    one, two_perlin_spheres) whose live lanes are ``layout``: ``dead``,
    ``live``, ``one`` (a seeded lane) or a seeded share (``1%``, ``5%``);
    and a seeded cotangent, zero on o, d, beta where the step ends the
    path, as in :func:`_train_inputs`."""
    scene, flags, tables, st, spec, _ = _train_inputs(
        device, n, "two_perlin_spheres" if rich else "ball_scenes", 0)
    r = np.random.default_rng(n + rich)
    alive = np.zeros(n, bool)
    if layout == "live":
        alive[:] = True
    elif layout == "one":
        alive[r.integers(n)] = True
    elif layout.endswith("%"):
        alive = r.random(n) < float(layout[:-1]) / 100
    st["alive"] = torch.from_numpy(alive).to(device)
    with torch.no_grad():
        ends = ~kb.bounce_step_ref(scene, flags, tables["mat"], st,
                                   spec)["alive"]
    ct = {k: torch.from_numpy(r.standard_normal((n, 3)).astype(np.float32))
          .to(device) for k in kbb.ROWS}
    for k in ("o", "d", "beta"):
        ct[k][ends] = 0.0
    return scene, flags, tables, st, spec, ct


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, 262144])
@pytest.mark.parametrize("layout", ["dead", "live", "one", "1%", "5%",
                                    "90%"])
@pytest.mark.parametrize("rich", [False, True])
def test_bwd_kernel_sweeps_the_live_lanes_on_gpu(rich, layout, n,
                                                 cuda_device):
    """B5 sweeps the live lanes, over the lanes (the lean 16,384) or over
    the list (the others): on wavefronts all dead, all live, one lane
    live, 1%, 5% and 90% live, lean and rich, its cotangents hold to
    ``torch.autograd`` of the plain step under the gradient contract; a
    dead lane's rows are its cotangents and its material row and id 0, to
    the bit; a second launch on the same inputs gives the same bits; and
    its count of the lanes it swept is the live lanes."""
    scene, flags, tables, st, spec, ct = _b5_inputs(cuda_device, n, rich,
                                                    layout)
    live = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    outs = [kbb.lane_cotangents(scene, flags, tables, st, ct, spec,
                                live[k].data_ptr()) for k in range(2)]
    g_ref, d_mat_ref = kbb.bounce_bwd_reference(scene, flags, tables["mat"],
                                                st, ct, spec)
    torch.cuda.synchronize()
    alive = st["alive"]
    assert live.tolist() == [int(alive.sum())] * 2
    (g, g_mat, wmat), (g2, g_mat2, wmat2) = outs
    for k in kbb.ROWS:
        assert torch.equal(_bits(g[k]), _bits(g2[k])), k
        assert torch.equal(_bits(g[k][~alive]), _bits(ct[k][~alive])), k
    assert torch.equal(_bits(g_mat), _bits(g_mat2))
    assert torch.equal(wmat, wmat2)
    assert torch.equal(_bits(g_mat[~alive]), torch.zeros_like(
        _bits(g_mat[~alive])))
    assert not wmat[~alive].any()
    contract.check_grads({k: g_ref[k].cpu().numpy() for k in kbb.ROWS},
                         {k: g[k].cpu().numpy() for k in kbb.ROWS})
    a = d_mat_ref.cpu().numpy()
    b = kseg.material_sum(g_mat, wmat, tables["mat"].shape[0]).cpu().numpy()
    if layout == "dead":
        assert not a.any() and not b.any()
    else:
        np.testing.assert_allclose(b, a, rtol=contract.GRAD_RTOL,
                                   atol=1e-4 * np.abs(a).max())


@pytest.mark.cuda
@pytest.mark.parametrize("rich", [False, True])
def test_bwd_kernel_lane_ignores_the_other_lanes_on_gpu(rich, cuda_device):
    """A lane's outputs do not depend on which other lanes are live, nor
    on how the launch sweeps: B5 on a 5%-live wavefront and on the same
    wavefront with every lane alive (both over the list), where the lanes
    live in both fall in other tiles, gives those lanes the same bits; and
    on its first 4,096 lanes alone (over the lanes) every lane of them the
    bits of the 5%-live launch."""
    scene, flags, tables, st, spec, ct = _b5_inputs(cuda_device, 65536,
                                                    rich, "5%")
    sparse = kbb.lane_cotangents(scene, flags, tables, st, ct, spec)
    every = kbb.lane_cotangents(scene, flags, tables,
                                dict(st, alive=torch.ones_like(st["alive"])),
                                ct, spec)
    head = 4096
    part = kbb.lane_cotangents(
        scene, flags, tables,
        {k: v[:head].contiguous() for k, v in st.items()},
        {k: v[:head].contiguous() for k, v in ct.items()}, spec)
    torch.cuda.synchronize()
    both = st["alive"]
    assert 0 < int(both.sum()) < both.shape[0] // 10
    assert 0 < int(both[:head].sum())
    for k in kbb.ROWS:
        assert torch.equal(_bits(sparse[0][k][both]),
                           _bits(every[0][k][both])), k
        assert torch.equal(_bits(sparse[0][k][:head]), _bits(part[0][k])), k
    assert torch.equal(_bits(sparse[1][both]), _bits(every[1][both]))
    assert torch.equal(sparse[2][both], every[2][both])
    assert torch.equal(_bits(sparse[1][:head]), _bits(part[1]))
    assert torch.equal(sparse[2][:head], part[2])


def _tri_inputs(device, n):
    """A mid-flight cornell_boxes state on ``device``: camera rays (64x64,
    1 spp, in a seeded order), two plain bounces with the depth cap, dead
    lanes refilled with fresh rays, then a seeded half of the lanes dead;
    and each lane's closest triangle from the plain walk."""
    scene, cam, _ = get_scene("cornell_boxes", device=device)
    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=50)
    r = np.random.default_rng(6)
    pix = torch.from_numpy(r.integers(0, 64 * 64, 2 * n)).to(device)
    (o, d, t), salt = camera_rays(cam, pix, 1, width=64, height=64, seed=4)
    st = dict(o=o[:n], d=d[:n], time=t[:n], beta=torch.ones_like(o[:n]),
              radiance=torch.zeros_like(o[:n]), salt=salt[:n],
              alive=torch.ones(n, dtype=torch.bool, device=device),
              depth=torch.zeros(n, dtype=torch.int32, device=device))
    with torch.no_grad():
        for _ in range(2):
            st = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    dead = ~st["alive"]
    for k, v in (("o", o[n:]), ("d", d[n:]), ("salt", salt[n:])):
        st[k] = torch.where(dead[:, None] if v.dim() == 2 else dead, v,
                            st[k])
    st["alive"] = torch.from_numpy(r.random(n) < 0.5).to(device)
    st = {k: v.contiguous() for k, v in st.items()}
    tri = ki.intersect_tris_reference(scene, st["o"], st["d"])
    return scene, flags, tables, st, spec, tri


def test_triangle_wrappers_check_their_arguments():
    """On the CPU no kernel runs, but the launch arguments are built and
    checked: B2 on a triangle scene needs B3's hit, with an int32 index."""
    scene, flags, tables, st, spec, tri = _tri_inputs("cpu", 300)
    with pytest.raises(ValueError, match="closest hit"):
        kb.fwd_args(scene, flags, tables, st, spec)
    with pytest.raises(ValueError, match="idx"):
        kb.fwd_args(scene, flags, tables, st, spec, tri)
    args, _ = kb.fwd_args(scene, flags, tables, st, spec,
                          (*tri[:3], tri[3].to(torch.int32)))
    assert args.n_tris == 24 and args.tri_idx
    assert args.rich == 0       # cornell_boxes takes the lean external hit
    args, out = ki.kernel_args(ki.pack_tables(scene), st["o"], st["d"])
    assert args.n == 300 and args.n_nodes == scene.n_bvh_nodes
    assert [x.dtype for x in out] == [torch.float32] * 3 + [torch.int32]
    with pytest.raises(ValueError, match="rays"):
        ki.kernel_args(ki.pack_tables(scene), st["o"].T, st["d"])


@pytest.mark.cuda
def test_triangle_kernels_match_plain_on_gpu(cuda_device):
    """One launch of B3 against the plain walk and one of B2 in its
    external-hit mode against the plain step fed the same hit, on 20,000
    mid-flight cornell_boxes lanes (a partial last block)."""
    scene, flags, tables, st, spec, tri = _tri_inputs(cuda_device, 20000)
    launches = launch_counts()["B3"]
    t, u, v, idx = ki.intersect_tris(scene, ki.pack_tables(scene), st["o"],
                                     st["d"])
    torch.cuda.synchronize()
    assert launch_counts()["B3"] == launches + 1
    hit = tri[0] < 3e38
    assert torch.equal(t < 3e38, hit) and int(hit.sum()) > 1000
    assert torch.equal(idx.long()[hit], tri[3][hit])
    for a, b in ((t, tri[0]), (u, tri[1]), (v, tri[2])):
        assert float((a - b)[hit].abs().max()) <= 2e-5
    fwd = launch_counts()["B2"]
    out = kb.bounce_fwd(scene, flags, tables, st, spec, (t, u, v, idx))
    ref = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec,
                             (t, u, v, idx))
    torch.cuda.synchronize()
    assert launch_counts()["B2"] == fwd + 1
    assert torch.equal(out["depth"], ref["depth"])
    contract.check_bounce(
        {k: ref[k].cpu().numpy() for k in ("alive", "d", "beta", "radiance")},
        {k: out[k].cpu().numpy() for k in ("alive", "d", "beta", "radiance")})


def _clustered_soup(device, n):
    """``_torch_scenes.clustered_soup`` on ``device``."""
    b, o, d = clustered_soup(SceneBuilder, n)
    return (b.build(device), torch.from_numpy(o).to(device),
            torch.from_numpy(d).to(device))


def test_two_level_wrapper_checks_its_arguments():
    """On the CPU no kernel runs, but B4's arguments are built and checked:
    16-byte aligned rows of the widths the kernel reads, the clusters back
    to back."""
    scene, o, d = _clustered_soup("cpu", 300)
    tables = ki.pack_big_tables(scene)
    n_cl = scene.cl_tris.shape[0]
    assert n_cl > 10
    assert tables["nodes"].shape == (int(tables["clusters"][:, 3].sum()), 8)
    assert tables["tris"].shape == (scene.n_tris, 12)
    assert tables["clusters"].shape == (n_cl, 4)
    args, out = ki.big_kernel_args(tables, o, d)
    assert (args.n, args.n_top, args.count_bits) == (
        300, scene.top_skip.shape[0], 3)
    assert [x.dtype for x in out] == [torch.float32] * 3 + [torch.int32]
    shifted = tables["nodes"].view(-1)[1:-7].view(-1, 8)   # 4 B off
    with pytest.raises(ValueError, match="aligned"):
        ki.big_kernel_args(dict(tables, nodes=shifted), o, d)
    with pytest.raises(ValueError, match="aligned"):
        ki.big_kernel_args(dict(tables, tris=tables["tris"][:, :9]), o, d)
    with pytest.raises(ValueError, match="rays"):
        ki.big_kernel_args(tables, o.T, d)


@pytest.mark.cuda
def test_two_level_kernel_matches_plain_on_gpu(cuda_device):
    """One launch of B4 through its wrapper against the plain two-level
    walk and one launch of B3 on the same rays, on 20,000 rays through a
    clustered soup (a partial last block): hits, indices and (t, u, v)
    equal to the bit, as the walks share their arithmetic and their
    order."""
    scene, o, d = _clustered_soup(cuda_device, 20000)
    tables = ki.pack_big_tables(scene)
    launches = launch_counts()["B4"]
    got = ki.intersect_tris_big(scene, tables, o, d)
    ref = ki.intersect_tris_big_reference(scene, o, d)
    single = ki.intersect_tris(scene, ki.pack_tables(scene), o, d)
    torch.cuda.synchronize()
    assert launch_counts()["B4"] == launches + 1
    hit = ref[0] < 3e38
    assert int(hit.sum()) > 1000
    for out in (got, single):
        assert torch.equal(out[0] < 3e38, hit)
        assert torch.equal(out[3].long(), ref[3])
        for a, b in zip(out[:3], ref[:3]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_specular_media_bounce_matches_plain_on_gpu(cuda_device):
    """One launch of B2 in its external-hit mode on a teapot_scene state
    (divs=6; camera rays through the image's lower half, which holds the
    teapots and the glass sphere, after two plain bounces) against the
    plain step fed the same hit: the specular branch and the media sweep
    within the per-bounce contract, depth exact."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene("teapot_scene", device=cuda_device, divs=6)
    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=50)
    n = 20000
    r = np.random.default_rng(9)
    pix = torch.from_numpy(r.integers(64 * 32, 64 * 64, n)).to(cuda_device)
    (o, d, t), salt = camera_rays(cam, pix, 1, width=64, height=64, seed=2)
    st = dict(o=o, d=d, time=t, beta=torch.ones_like(o),
              radiance=torch.zeros_like(o), salt=salt,
              alive=torch.ones(n, dtype=torch.bool, device=cuda_device),
              depth=torch.zeros(n, dtype=torch.int32, device=cuda_device))
    with torch.no_grad():
        for _ in range(2):
            st = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    st = {k: v.contiguous() for k, v in st.items()}
    hit = ki.intersect_tris(scene, ki.pack_tables(scene), st["o"], st["d"])
    fwd = launch_counts()["B2"]
    out = kb.bounce_fwd(scene, flags, tables, st, spec, hit)
    ref = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec, hit)
    torch.cuda.synchronize()
    assert launch_counts()["B2"] == fwd + 1
    assert int(st["alive"].sum()) > 2000
    assert torch.equal(out["depth"], ref["depth"])
    contract.check_bounce(
        {k: ref[k].cpu().numpy() for k in ("alive", "d", "beta", "radiance")},
        {k: out[k].cpu().numpy() for k in ("alive", "d", "beta", "radiance")})


def _winner_inputs(device, name, n=20000):
    """Rays for the sphere winner: ball_scenes camera rays after one plain
    bounce (lanes on the balls, the floor and the dome), or ``n`` seeded
    rays through a scene of 20 spheres, every fourth moving and every
    fourth flipped, in an env dome."""
    if name == "moving":
        r = np.random.default_rng(12)
        b = SceneBuilder()
        m = b.lambertian(b.constant((0.5, 0.5, 0.5)))
        for i in range(20):
            c = r.uniform(-4, 4, 3)
            b.sphere(c, 0.5, m, flip=i % 4 == 1,
                     center1=c + r.uniform(-1, 1, 3) if i % 4 == 0 else None)
        b.sphere((0, 0, 0), 50.0, b.diffuse_light(b.constant((1, 1, 1))),
                 env=True)
        scene = b.build(device)
        o, d = (r.standard_normal((n, 3)).astype(np.float32) for _ in "od")
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = [torch.from_numpy(x).to(device) for x in
                (o * 2, d, r.uniform(0, 1, n).astype(np.float32))]
        return scene, kb.build_tables(scene, SceneFlags.of(scene))["sph"], rays
    scene, _, _, st, _, _ = _train_inputs(device, n)
    return (scene, kb.build_tables(scene, SceneFlags.of(scene))["sph"],
            [st[k] for k in ("o", "d", "time")])


def test_sphere_winner_wrapper_checks_its_arguments(monkeypatch):
    """On CPU tensors the wrapper is the plain version and launches
    nothing; B6's arguments are built and checked there too."""
    monkeypatch.setitem(tracer.COUNTS, "B6", 0)
    scene, sph, (o, d, t) = _winner_inputs("cpu", "moving", 300)
    got = ks.sphere_winner(scene, sph, o, d, t)
    want = ks.sphere_winner_reference(scene, o, d, t)
    assert launch_counts()["B6"] == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int((got[1] >= 0).sum()) == 300   # the env dome catches misses
    args, out = ks.kernel_args(sph, o, d, t, 1e-3)
    assert (args.n, args.n_sph) == (300, 21)
    assert [x.dtype for x in out] == [torch.float32, torch.int32]
    with pytest.raises(ValueError, match="rays"):
        ks.kernel_args(sph, o, d, t[:-1], 1e-3)
    with pytest.raises(ValueError, match="sphere table"):
        ks.kernel_args(sph[:, :11], o, d, t, 1e-3)
    with pytest.raises(ValueError, match="at most"):
        ks.kernel_args(sph.repeat(200, 1), o, d, t, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ball_scenes", "moving"])
def test_sphere_winner_matches_plain_on_gpu(name, cuda_device):
    """One launch of B6 against its plain version on 20,000 rays (a partial
    last block): the index equal and ``t`` equal to the bit (B6 runs the
    bounce kernels' own sphere test, and the build keeps
    ``--fmad=false``)."""
    scene, sph, rays = _winner_inputs(cuda_device, name)
    pt, pidx = ks.sphere_winner_reference(scene, *rays)
    assert int((pidx >= 0).sum()) > 1000
    launches = launch_counts()["B6"]
    t, idx = ks.sphere_winner(scene, sph, *rays)
    torch.cuda.synchronize()
    assert launch_counts()["B6"] == launches + 1
    assert torch.equal(idx, pidx)
    assert torch.equal(t, pt)


def _parity_inputs(device, n, name="ball_scenes", no_stale=False):
    """``_train_inputs``' mid-flight state with the parity flags, and on a
    triangle scene the plain walk's hit as B3 gives it."""
    scene, flags, tables, st, spec, _ = _train_inputs(device, n, name)
    flags = flags._replace(ref_parity=True, parity_no_stale=no_stale)
    tri = None
    if scene.n_tris:
        t, u, v, idx = ki.intersect_tris(scene, ki.pack_tables(scene),
                                         st["o"], st["d"])
        tri = (t, u, v, idx.to(torch.int32))
    return scene, flags, tables, st, spec, tri


@pytest.mark.parametrize("no_stale", [0, 1])
def test_parity_launch_arguments(no_stale):
    """B2's arguments under parity, built on the CPU: the parity
    instantiation, the diagnostic switch and the ``stale`` output; the
    default flags leave them unset. The CPU wrapper takes the plain
    version, which returns ``stale``, and launches nothing."""
    scene, flags, tables, st, spec, _ = _parity_inputs("cpu", 300,
                                                       no_stale=no_stale)
    args, out = kb.fwd_args(scene, flags, tables, st, spec)
    assert (args.parity, args.parity_no_stale) == (1, no_stale)
    assert args.stale_out == out["stale"].data_ptr()
    assert out["stale"].shape == (300,) and out["stale"].dtype == torch.float32
    args, out = kb.fwd_args(scene, flags._replace(ref_parity=False), tables,
                            st, spec)
    assert args.parity == 0 and not args.stale_out and "stale" not in out
    launches = launch_counts()["B2 parity"]
    got = kb.bounce_fwd(scene, flags, tables, st, spec)
    assert launch_counts()["B2 parity"] == launches
    assert got["stale"].shape == (300,)


@pytest.mark.cuda
@pytest.mark.parametrize("name,no_stale", [("ball_scenes", False),
                                           ("ball_scenes", True),
                                           ("cornell_boxes", False)])
def test_parity_bounce_matches_plain_on_gpu(cuda_device, name, no_stale):
    """One launch of B2's parity instantiation against the plain parity
    step on 20,000 mid-flight lanes (a partial last block), the ``stale``
    plane within its tolerance."""
    scene, flags, tables, st, spec, tri = _parity_inputs(
        cuda_device, 20000, name, no_stale)
    launches = launch_counts()["B2 parity"]
    out = kb.bounce_fwd(scene, flags, tables, st, spec, tri)
    ref = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec, tri)
    torch.cuda.synchronize()
    assert launch_counts()["B2 parity"] == launches + 1
    assert torch.equal(out["depth"], ref["depth"])
    keys = ("alive", "d", "beta", "radiance", "stale")
    contract.check_bounce({k: ref[k].cpu().numpy() for k in keys},
                          {k: out[k].cpu().numpy() for k in keys})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["earth_sphere", "lit_room_media"])
def test_float_atlas_matches_packed_on_gpu(name, cuda_device):
    """B1, B2 and B5 read a float atlas (``splice`` of ``"atlas"`` drops
    the packed rgb8 twin) whose values are the twin's u8/255: every output
    equal to the bit to the packed atlas's launch, on the scene's emitting
    image (earth_sphere) and its image albedo (lit_room_media)."""
    from srt_tpu_torch.diff import splice

    def same(a, b):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return torch.equal(a, b)

    inp, st, spec = _inputs(cuda_device, n=20000, name=name)
    flt = splice(inp.scene, {"atlas": inp.scene.atlas})
    inp_f = kb.RegenInputs(flt, inp.flags, inp.camera, inp.jitter)
    assert inp_f.fields["atlas_f32"] and not inp.fields["atlas_f32"]
    for _ in range(2):
        kb.regen_bounce_reference(inp, st, spec)
    a, b = ({k: v.clone() for k, v in st.items()} for _ in range(2))
    kb.regen_bounce(inp, a, spec)
    kb.regen_bounce(inp_f, b, spec)
    torch.cuda.synchronize()
    assert all(same(a[k], b[k]) for k in a)

    scene, flags, tables, st, spec, ct = _train_inputs(cuda_device, 20000,
                                                       name, 0)
    flt = splice(scene, {"atlas": scene.atlas})
    tab_f = kb.build_tables(flt, flags)
    out_p = kb.bounce_fwd(scene, flags, tables, st, spec)
    out_f = kb.bounce_fwd(flt, flags, tab_f, st, spec)
    g_p = kbb.lane_cotangents(scene, flags, tables, st, ct, spec)
    g_f = kbb.lane_cotangents(flt, flags, tab_f, st, ct, spec)
    torch.cuda.synchronize()
    assert all(same(out_p[k], out_f[k]) for k in out_p)
    assert all(same(g_p[0][k], g_f[0][k]) for k in kbb.ROWS)
    assert same(g_p[1], g_f[1]) and torch.equal(g_p[2], g_f[2])


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Float32 words as int32, every NaN as one word (the card's NaN is
    not the CPU's)."""
    x = x.cpu()
    return torch.where(torch.isnan(x), float("nan"), x).view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(FILM_LAYOUTS))
def test_film_kernel_matches_plain_on_gpu(layout, cuda_device):
    """The film kernel's sums and counts against the plain version's on
    the CPU (lane after lane), to the bit, twice: seeded lanes in
    ``layout`` (``tests/_torch_flushes.py``), NaN and +-inf radiance; the
    kernel's per-pixel scratch back at 0 after each launch."""
    acc0, pix, rad, fin, alive = (torch.from_numpy(x)
                                  for x in film_flush(layout))
    want = [acc0.clone(), torch.tensor(3), torch.tensor(4)]
    kfilm.film_sum_reference(*want, pix, rad, fin, alive)
    dev = cuda_device
    film = kfilm.Film(acc0.shape[1], pix.shape[0], dev)
    for run in range(2):
        film.acc.copy_(acc0)
        film.n_vertices.fill_(3)
        film.nan_scrubbed.fill_(4)
        film.flush(pix.to(dev), rad.to(dev), fin.to(dev), alive.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(_bits(film.acc), _bits(want[0])), run
        assert int(film.n_vertices) == int(want[1])
        assert int(film.nan_scrubbed) == int(want[2])
        assert film.clean()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 16384, 262144])
def test_material_sum_kernel_on_gpu(n, cuda_device):
    """The material-sum kernel: twice equal to the bit, equal to the bit
    to its order of adds in torch on the CPU (``material_sum_order``: adds
    carry no FMA, so the same order gives the same bits), and every row
    within the gradient contract of the plain version on the CPU."""
    r = np.random.default_rng(5)
    g = torch.from_numpy(r.standard_normal((n, 10)).astype(np.float32))
    seg = torch.from_numpy(r.integers(0, 124, n).astype(np.int32))
    seg[: n // 2] = 7   # one material over half the lanes, as the floor
    want = kseg.material_sum_reference(g, seg, 124)
    got = [kseg.material_sum(g.to(cuda_device), seg.to(cuda_device), 124)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[0]), _bits(got[1]))
    assert torch.equal(_bits(got[0]), _bits(kseg.material_sum_order(g, seg,
                                                                   124)))
    contract.check_grads({"d_mat": want.numpy()},
                         {"d_mat": got[0].cpu().numpy()}, frac=0.0)
    assert (got[0].cpu()[:, [0, 5, 12, 13]] == 0).all()
