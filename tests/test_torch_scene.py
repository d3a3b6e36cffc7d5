"""srt_tpu_torch scene building, flags, camera and coverage gate against
the JAX package's."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu.core.rng import RaySampler
from _torch_scenes import lit_room
from srt_tpu.scene import library as jlib
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu_torch import RenderConfig, convert, get_scene, render_regen
from srt_tpu_torch.core import rng
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import SceneFlags, TorchScene

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:asset .* missing")


def _arrays(scene) -> dict:
    return {k: (None if v is None else np.asarray(v))
            for k, v in scene._asdict().items()}


@pytest.fixture(scope="module")
def jax_balls():
    return jlib.ball_scenes(aspect=1.0)


def _both(name: str, jax_balls):
    """(port scene, JAX scene) built by each package's own builder."""
    if name == "ball_scenes":
        return get_scene("ball_scenes", device="cpu")[0], jax_balls[0]
    return (lit_room(SceneBuilder()).build("cpu"),
            lit_room(JaxSceneBuilder()).build())


@pytest.mark.parametrize("name", ["ball_scenes", "lit_room"])
def test_scene_tables_bit_equal(name, jax_balls):
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


@pytest.mark.parametrize("name,lights", [("ball_scenes", (0,)),
                                         ("lit_room", (0, 0))])
def test_scene_flags_equal(name, lights, jax_balls):
    got, scene_j = _both(name, jax_balls)
    flags = SceneFlags.of(got)
    want = JaxSceneFlags.of(scene_j)._asdict()
    assert flags._asdict() == {k: want[k] for k in flags._fields}
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


@pytest.mark.parametrize("name,item", [("two_perlin_spheres", "A7"),
                                       ("final", "A7"),
                                       ("simple_light", "A7"),
                                       ("random_scene", "A7")])
def test_uncovered_scenes_raise(name, item):
    scene_j, cam_j, _ = jlib.get_scene(name, aspect=1.0)
    scene = convert.scene_from_arrays(_arrays(scene_j), device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        render_regen(scene, cam, RenderConfig(width=4, height=4, spp=1))
    with pytest.raises(NotImplementedError):
        get_scene(name, device="cpu")


def test_media_and_parity_raise():
    scene, cam, _ = get_scene("ball_scenes", device="cpu")
    media = dataclasses.replace(scene,
                                med_kind=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="media"):
        render_regen(media, cam, RenderConfig(width=4, height=4, spp=1))
    with pytest.raises(NotImplementedError, match="A9"):
        render_regen(scene, cam, RenderConfig(width=4, height=4, spp=1,
                                              ref_parity=True))


def test_render_config_fields_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(RenderConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(JaxRenderConfig)])
