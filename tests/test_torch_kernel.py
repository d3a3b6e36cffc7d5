"""The CUDA kernels (srt_tpu_torch/csrc/): the regeneration bounce
(``regen_bounce.cu``), the per-bounce step (``bounce.cu``, the train
forward, and with a triangle hit the bounce of triangle scenes), its VJP,
the train backward (``bounce_bwd.cu``), the triangle BVH walks, single
level (``intersect_tris.cu``) and two level (``intersect_big.cu``), and
the sphere winner of the hybrid backward (``sphere_winner.cu``).

On a machine with an NVIDIA GPU the ``cuda``-marked tests build the
kernels and hold one launch of each against its plain version lane by
lane; here, without a card, they skip. The CPU tests check that the
wrappers take the plain versions for CPU tensors without launching
anything, and what the build is asked to do.
"""
from __future__ import annotations

import shutil
import warnings

import numpy as np
import pytest
import torch
from _torch_scenes import LIT_ROOM_CAMERA, lit_room, lit_room_media

from srt_tpu_torch import get_scene
from srt_tpu_torch.core.sobol import sobol_points
from srt_tpu_torch.diff.inverse import camera_rays
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.kernels import build
from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.kernels import spheres as ks
from srt_tpu_torch.render.camera import Camera
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import SceneFlags
from srt_tpu_torch.utils import contract

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
    monkeypatch.setattr(kb, "LAUNCHES", 0)
    inp, st, spec = _inputs("cpu", n=300)
    ref = {k: v.clone() for k, v in st.items()}
    kb.regen_bounce(inp, st, spec)
    kb.regen_bounce_reference(inp, ref, spec)
    assert kb.LAUNCHES == 0
    for k in ("o", "d", "beta", "radiance", "salt", "pix", "depth", "alive",
              "fin", "dead", "cursor"):
        assert torch.equal(st[k], ref[k]), k
    # 300 lanes = one full block and one of 44; all lanes were dead
    assert int(ref["cursor"][0]) == 2048 + 300
    assert ref["dead"].tolist() == [int((ref["alive"][:256] == 0).sum()),
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
    assert build.library_path().startswith(build.BUILD_DIR)


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


def test_train_wrappers_take_the_plain_version(monkeypatch):
    """On CPU tensors the forward and backward wrappers are the plain step
    and ``torch.autograd`` of it, and launch nothing."""
    monkeypatch.setattr(kb, "LAUNCHES_FWD", 0)
    monkeypatch.setattr(kbb, "LAUNCHES_BWD", 0)
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
    assert kb.LAUNCHES_FWD == 0 and kbb.LAUNCHES_BWD == 0


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
    launches = kb.LAUNCHES
    kb.regen_bounce(inp, st_k, spec)
    kb.regen_bounce_reference(inp, st, spec)
    torch.cuda.synchronize()
    assert kb.LAUNCHES == launches + 1
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
    launches = kb.LAUNCHES_FWD
    out = kb.bounce_fwd(scene, flags, tables, st, spec)
    ref = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    torch.cuda.synchronize()
    assert kb.LAUNCHES_FWD == launches + 1
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
    fwd, bwd = kb.LAUNCHES_FWD, kbb.LAUNCHES_BWD
    rich = kbb.LAUNCHES_BWD_RICH
    out = kb.bounce_fwd(scene, flags, tables, st, spec)
    ref = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    torch.cuda.synchronize()
    assert kb.LAUNCHES_FWD == fwd + 1
    assert torch.equal(out["depth"], ref["depth"])

    def arrays(s):
        return {k: s[k].cpu().numpy() for k in ("alive", "d", "beta",
                                                "radiance")}
    contract.check_bounce(arrays(ref), arrays(out))

    g, d_mat = kbb.bounce_bwd(scene, flags, tables, st, ct, spec)
    g_ref, d_mat_ref = kbb.bounce_bwd_reference(scene, flags, tables["mat"],
                                                st, ct, spec)
    torch.cuda.synchronize()
    assert kbb.LAUNCHES_BWD == bwd + 1
    assert kbb.LAUNCHES_BWD_RICH == rich + (name not in ("ball_scenes",
                                                         "lit_room"))
    contract.check_grads({k: g_ref[k].cpu().numpy() for k in kbb.ROWS},
                         {k: g[k].cpu().numpy() for k in kbb.ROWS})
    a, b = d_mat_ref.cpu().numpy(), d_mat.cpu().numpy()
    assert np.abs(a).max() > 0.0
    np.testing.assert_allclose(b, a, rtol=contract.GRAD_RTOL,
                               atol=1e-4 * np.abs(a).max())


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
    launches = ki.LAUNCHES
    t, u, v, idx = ki.intersect_tris(scene, ki.pack_tables(scene), st["o"],
                                     st["d"])
    torch.cuda.synchronize()
    assert ki.LAUNCHES == launches + 1
    hit = tri[0] < 3e38
    assert torch.equal(t < 3e38, hit) and int(hit.sum()) > 1000
    assert torch.equal(idx.long()[hit], tri[3][hit])
    for a, b in ((t, tri[0]), (u, tri[1]), (v, tri[2])):
        assert float((a - b)[hit].abs().max()) <= 2e-5
    fwd = kb.LAUNCHES_FWD
    out = kb.bounce_fwd(scene, flags, tables, st, spec, (t, u, v, idx))
    ref = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec,
                             (t, u, v, idx))
    torch.cuda.synchronize()
    assert kb.LAUNCHES_FWD == fwd + 1
    assert torch.equal(out["depth"], ref["depth"])
    contract.check_bounce(
        {k: ref[k].cpu().numpy() for k in ("alive", "d", "beta", "radiance")},
        {k: out[k].cpu().numpy() for k in ("alive", "d", "beta", "radiance")})


def _clustered_soup(device, n):
    """A 1,500-triangle soup clustered at caps 128/256 (dozens of clusters
    under a deep top tree) and ``n`` random rays through it."""
    r = np.random.default_rng(8)
    b = SceneBuilder(cluster_node_cap=128, cluster_tri_cap=256)
    b.triangles(r.standard_normal((1500, 3, 3)).astype(np.float32),
                b.lambertian(b.constant((0.5, 0.5, 0.5))))
    scene = b.build(device)
    o = (r.standard_normal((n, 3)) * 3).astype(np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (scene, torch.from_numpy(o).to(device),
            torch.from_numpy(d).to(device))


def test_two_level_wrapper_checks_its_arguments():
    """On the CPU no kernel runs, but B4's arguments are built and checked:
    the records hold whole padded cluster blocks."""
    scene, o, d = _clustered_soup("cpu", 300)
    tables = ki.pack_big_tables(scene)
    n_cl = scene.cl_tris.shape[0]
    assert n_cl > 10
    assert tables["nodes"].shape == (n_cl * 128, 9)
    assert tables["tris"].shape == (n_cl * 256, 9)
    args, out = ki.big_kernel_args(tables, o, d)
    assert (args.n, args.n_top, args.node_cap, args.tri_cap) == (
        300, scene.top_skip.shape[0], 128, 256)
    assert [x.dtype for x in out] == [torch.float32] * 3 + [torch.int32]
    with pytest.raises(ValueError, match="padded blocks"):
        ki.big_kernel_args(dict(tables, nodes=tables["nodes"][:-1]), o, d)
    with pytest.raises(ValueError, match="rays"):
        ki.big_kernel_args(tables, o.T, d)


@pytest.mark.cuda
def test_two_level_kernel_matches_plain_on_gpu(cuda_device):
    """One launch of B4 against the plain two-level walk and one of B3 on
    the same rays, on 20,000 rays through a clustered soup (a partial last
    block): hits, indices and (t, u, v) equal, as the walks share their
    arithmetic."""
    scene, o, d = _clustered_soup(cuda_device, 20000)
    launches = ki.LAUNCHES_BIG
    got = ki.intersect_tris_big(scene, ki.pack_big_tables(scene), o, d)
    ref = ki.intersect_tris_big_reference(scene, o, d)
    single = ki.intersect_tris(scene, ki.pack_tables(scene), o, d)
    torch.cuda.synchronize()
    assert ki.LAUNCHES_BIG == launches + 1
    hit = ref[0] < 3e38
    assert int(hit.sum()) > 1000
    for out in (got, single):
        assert torch.equal(out[0] < 3e38, hit)
        assert torch.equal(out[3].long()[hit], ref[3][hit])
        for a, b, tol in zip(out[:3], ref[:3], (2e-5, 1e-4, 1e-4)):
            assert float((a - b)[hit].abs().max()) <= tol


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
    fwd = kb.LAUNCHES_FWD
    out = kb.bounce_fwd(scene, flags, tables, st, spec, hit)
    ref = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec, hit)
    torch.cuda.synchronize()
    assert kb.LAUNCHES_FWD == fwd + 1
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
    monkeypatch.setattr(ks, "LAUNCHES", 0)
    scene, sph, (o, d, t) = _winner_inputs("cpu", "moving", 300)
    got = ks.sphere_winner(scene, sph, o, d, t)
    want = ks.sphere_winner_reference(scene, o, d, t)
    assert ks.LAUNCHES == 0
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
    launches = ks.LAUNCHES
    t, idx = ks.sphere_winner(scene, sph, *rays)
    torch.cuda.synchronize()
    assert ks.LAUNCHES == launches + 1
    assert torch.equal(idx, pidx)
    assert torch.equal(t, pt)
