"""srt_tpu_torch scene building, flags, camera and coverage gate against
the JAX package's."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu.core.rng import RaySampler
from _torch_scenes import lit_room, lit_room_media
from srt_tpu.scene import library as jlib
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu_torch import (RenderConfig, convert, get_scene, make_train_step,
                           render, render_regen)
from srt_tpu_torch.core import rng
from srt_tpu_torch.render.api import PORT_CONFIG
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import PORT_FLAGS, SceneFlags, TorchScene

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:asset .* missing")


def _arrays(scene) -> dict:
    return {k: (None if v is None else np.asarray(v))
            for k, v in scene._asdict().items()}


@pytest.fixture(scope="module")
def jax_balls():
    return jlib.ball_scenes(aspect=1.0)


#: the library scenes this slice adds, each against JAX's own
LIBRARY = ["ball_orennayar_scenes", "final1", "cornell_box", "random_scene",
           "two_spheres", "two_perlin_spheres", "earth_sphere",
           "simple_light", "final"]
BUILT = {"lit_room": lit_room, "lit_room_media": lit_room_media}


def _both(name: str, jax_balls):
    """(port scene, JAX scene) built by each package's own builder or
    library."""
    if name == "ball_scenes":
        return get_scene("ball_scenes", device="cpu")[0], jax_balls[0]
    if name in BUILT:
        return (BUILT[name](SceneBuilder()).build("cpu"),
                BUILT[name](JaxSceneBuilder()).build())
    return get_scene(name, device="cpu")[0], jlib.get_scene(name)[0]


@pytest.mark.parametrize("name", ["ball_scenes", "lit_room",
                                  "lit_room_media"] + LIBRARY)
def test_scene_tables_bit_equal(name, jax_balls):
    """Every table, the Perlin tables and ``tex_scale`` among them, equal
    to the bit; and the library's ``info`` equal to JAX's."""
    got, scene_j = _both(name, jax_balls)
    want = convert.scene_from_arrays(_arrays(scene_j), device="cpu")
    for f in dataclasses.fields(TorchScene):
        a, b = getattr(got, f.name), getattr(want, f.name)
        # the two-level BVH exists on scenes with triangles only
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a, b), f.name
    if name == "ball_scenes":
        assert get_scene(name, device="cpu")[2] == jax_balls[2]
    elif name in LIBRARY:
        assert get_scene(name, device="cpu")[2] == jlib.get_scene(name)[2]
    assert got.perlin_vec.shape == (256, 3)
    assert got.perlin_perm.shape == (3, 256)


@pytest.mark.parametrize("name,lights", [("ball_scenes", (0,)),
                                         ("lit_room", (0, 0)),
                                         ("random_scene", (0,) * 6),
                                         ("two_spheres", (1,)),
                                         ("earth_sphere", (1,)),
                                         ("final", (0,))])
def test_scene_flags_equal(name, lights, jax_balls):
    got, scene_j = _both(name, jax_balls)
    flags = SceneFlags.of(got)
    want = JaxSceneFlags.of(scene_j)._asdict()
    shared = [k for k in flags._fields if k not in PORT_FLAGS]
    assert ({k: getattr(flags, k) for k in shared}
            == {k: want[k] for k in shared})
    assert not flags.mesh_media
    assert flags.fused_bounce and flags.light_kinds == lights


def test_camera_matches(jax_balls):
    _, cam_j, _ = jax_balls
    _, cam, _ = get_scene("ball_scenes", device="cpu")
    rec_j = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()},
        device="cpu").record()
    np.testing.assert_allclose(cam.record().numpy(), rec_j.numpy(),
                               rtol=1e-6, atol=1e-6)
    r = np.random.default_rng(0)
    pix = r.integers(0, 1 << 18, 4096).astype(np.int32)
    samp = r.integers(0, 16, 4096).astype(np.int32)
    s, t = (r.uniform(size=4096).astype(np.float32) for _ in range(2))
    sampler = RaySampler.create(0, pix, samp)
    ray = cam_j.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                     sampler.uniform(34))
    salt = rng.create_salt(0, torch.from_numpy(pix), torch.from_numpy(samp))
    o, d, tm = cam.rays(torch.from_numpy(s), torch.from_numpy(t),
                        rng.uniform(salt, 32), rng.uniform(salt, 33),
                        rng.uniform(salt, 34))
    for a, b in ((o, ray.origin), (d, ray.direction), (tm, ray.time)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def _mesh_medium(scene):
    """One medium bounded by a mesh (kind 2, ``medium_mesh``)."""
    return dataclasses.replace(
        scene, med_kind=torch.full((1,), 2, dtype=torch.int32),
        med_center=torch.zeros((1, 3)), med_radius=torch.zeros(1),
        med_half=torch.zeros((1, 3)), med_density=torch.ones(1),
        med_mat=torch.zeros(1, dtype=torch.int32))


def _merl(scene):
    """The last material a measured BRDF (MERL) with its table."""
    mt = scene.mat_type.clone()
    mt[-1] = 7
    return dataclasses.replace(scene, mat_type=mt,
                               merl=torch.zeros((1, 3, 1)))


@pytest.mark.parametrize("case,item", [("parity", "A6"), ("merl", "A12"),
                                       ("mesh_medium", "A7"),
                                       ("train_mesh_medium", "A7")])
def test_uncovered_scenes_raise(case, item):
    """Of the scenes the port once refused, ``item`` names the ROADMAP item
    that covered it: MERL materials (A12) render and train through the
    plain bounce, which the bounce kernels' gate gives them. Parity's
    sequential heap-slot mode
    (``seq_stale``, A6) renders on the scan engine, and mesh-bounded media
    (A7) render through the plain bounce and train through it (random_scene,
    whose checker ground and specular spheres the train step refused
    before its backward had them, trains: ``test_torch_train_rich.py``).
    A medium of kind 2 without boundary triangles crosses as a sphere,
    as in the JAX integrator."""
    name = "random_scene" if case == "train_mesh_medium" else "ball_scenes"
    scene, cam, _ = get_scene(name, device="cpu")
    cfg = RenderConfig(width=4, height=4, spp=1)
    if case == "merl":
        img, m = render_regen(_merl(scene), cam, cfg, metrics=True)
        assert m.bounce == "plain" and torch.isfinite(img).all()
        step = make_train_step(_merl(scene), cam,
                               {"tex_color": scene.tex_color}, width=4,
                               height=4, spp=1, max_depth=2, device="cpu")
        assert torch.isfinite(step(torch.full((4, 4, 3), 0.3), 0))
        return
    if case == "train_mesh_medium":
        step = make_train_step(_mesh_medium(scene), cam,
                               {"tex_color": scene.tex_color}, width=4,
                               height=4, spp=1, max_depth=2, device="cpu")
        assert torch.isfinite(step(torch.full((4, 4, 3), 0.3), 0))
        return
    if case == "parity":
        img = render(scene, cam, dataclasses.replace(
            cfg, ref_parity=True, seq_stale=True))
    else:
        img = render_regen(_mesh_medium(scene), cam, cfg)
    assert img.shape == (4, 4, 3) and torch.isfinite(img).all()


def test_mesh_asset_scenes_not_registered():
    """The scenes of scanned meshes waited for the mesh loaders (A8): now
    registered, the library holds every scene of JAX's, and each builds
    with its mesh asset absent, skipped and named in ``info``, as JAX's
    does."""
    from srt_tpu_torch.scene.library import list_scenes
    assert sorted(list_scenes()) == sorted(jlib.list_scenes())
    for name, rel in (("jadebunny_scene", "models/bunny.ply"),
                      ("soldier_scene", "models/Soilder.FBX"),
                      ("flatnormal_bunny", "models/bunny.ply")):
        scene, _, info = get_scene(name, device="cpu")
        assert rel in info["skipped"] and scene.n_tris == 0


def test_media_and_parity_raise():
    """Neither raises any longer: a mesh-bounded medium renders through
    the plain bounce, parity's sequential heap-slot mode on the scan
    engine (its image is the parity scan render's at one sample a chunk,
    the carried plane being inert)."""
    scene, cam, _ = get_scene("ball_scenes", device="cpu")
    media = _mesh_medium(scene)
    img, m = render_regen(media, cam, RenderConfig(width=4, height=4, spp=1),
                          metrics=True)
    assert m.bounce == "plain" and torch.isfinite(img).all()
    cfg = RenderConfig(width=4, height=4, spp=2, max_depth=4,
                       ref_parity=True, sample_chunk=1)
    assert torch.equal(render(scene, cam, dataclasses.replace(
        cfg, seq_stale=True)), render(scene, cam, cfg))


def test_render_config_fields_match_jax():
    """JAX's fields, names and defaults in its order, then the port's own
    (``PORT_CONFIG``), each off by default."""
    got = [(f.name, f.default) for f in dataclasses.fields(RenderConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JaxRenderConfig)]
    assert got[:len(want)] == want
    assert got[len(want):] == [(k, False) for k in PORT_CONFIG]
