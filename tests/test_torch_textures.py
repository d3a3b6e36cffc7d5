"""The port's textures and sphere lights against the JAX package's.

Inputs come from numpy with fixed seeds and go through both packages on
tables built by each package's own SceneBuilder (bit-equal, checked
here). The JAX functions run op by op (``jax.disable_jit``), so neither
side contracts multiply-adds and the two agree to float rounding.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.materials import textures as jtex
from srt_tpu.render import lights as jlights
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu_torch import convert
from srt_tpu_torch.materials import textures
from srt_tpu_torch.render import lights
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import SceneFlags, TorchScene

torch.set_num_threads(1)
N = 4096


def _fill(b):
    """Every texture family and both light kinds: a constant, two
    checkers, marbles at scales 0.1, 1 and 4, an image; a rect light, a
    radius-2 sphere light and an env dome registered as a sphere light."""
    b.constant((0.3, 0.5, 0.7))
    b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.checker((1.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    for scale in (0.1, 1.0, 4.0):
        b.noise(scale)
    texels = (np.arange(6 * 9 * 3).reshape(6, 9, 3) * 4 + 7).astype(np.uint8)
    b.image(texels)
    light = b.diffuse_light(0)
    b.light_rect(b.xz_rect(-1, 1, -2, 3, 6, light, flip=True))
    b.light_sphere(b.sphere((0.0, 2.0, 0.0), 2.0, light))
    b.light_sphere(b.sphere((0.0, 0.0, 0.0), 1000.0, light, env=True))
    return b


@pytest.fixture(scope="module")
def scenes():
    scene_j = _fill(JaxSceneBuilder()).build()
    scene = _fill(SceneBuilder()).build("cpu")
    want = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    for f in dataclasses.fields(TorchScene):
        a, b = getattr(scene, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        assert a is None or torch.equal(a, b), f.name
    return scene_j, scene


def _points(seed: int, spread: float):
    r = np.random.default_rng(seed)
    p = r.uniform(-spread, spread, (N, 3)).astype(np.float32)
    uv = r.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    return p, uv


@pytest.mark.parametrize("kind,spread", [("checker", 3.0), ("noise", 3.0),
                                         ("noise", 300.0), ("image", 1.0),
                                         ("all", 30.0)])
def test_texture_value_matches_jax(scenes, kind, spread):
    """``texture_value`` on 4,096 seeded points, negative coordinates
    included (the Perlin lattice wraps by ``& 255``): within 1e-5; a
    checker lane may flip only where its three sines' product is within
    float rounding of zero, and none flips here."""
    scene_j, scene = scenes
    tt = scene.tex_type.numpy()
    ids = {"checker": np.flatnonzero(tt == 1), "noise": np.flatnonzero(tt == 2),
           "image": np.flatnonzero(tt == 3), "all": np.arange(len(tt))}[kind]
    seed = {"checker": 1, "noise": 2, "image": 3, "all": 4}[kind]
    p, uv = _points(seed + int(spread), spread)
    tex = np.random.default_rng(3).choice(ids, N).astype(np.int32)
    with jax.disable_jit():
        want = np.asarray(jtex.texture_value(
            scene_j, jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(p),
            JaxSceneFlags.of(scene_j)))
    got = textures.texture_value(
        scene, torch.from_numpy(tex).long(), torch.from_numpy(uv),
        torch.from_numpy(p), SceneFlags.of(scene)).numpy()
    diff = np.abs(got - want).max(-1)
    chk = tt[tex] == 1
    flips = int((diff[chk] > 1e-5).sum())
    assert flips == 0, flips
    assert diff.max() <= 1e-5, diff.max()
    if kind == "noise":
        m = got[:, 0]
        assert 0.0 <= m.min() and m.max() <= 1.0 and m.std() > 0.05


def test_perlin_noise_matches_jax(scenes):
    """One octave of noise, the building block, on negative and positive
    lattice cells: within 1e-6."""
    scene_j, scene = scenes
    p, _ = _points(11, 40.0)
    with jax.disable_jit():
        want = np.asarray(jtex.perlin_noise(scene_j, jnp.asarray(p)))
    got = textures.perlin_noise(scene, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (p < 0).any() and np.abs(got).max() > 0.1


def _light_inputs(seed: int):
    r = np.random.default_rng(seed)
    # half the points within 3 of the radius-2 sphere light's centre (some
    # inside it), all inside the dome
    p = np.concatenate([r.uniform(-8, 8, (N // 2, 3)),
                        r.normal(0, 1.5, (N // 2, 3)) + [0, 2, 0]])
    u = r.uniform(size=(3, N))
    return p.astype(np.float32), u.astype(np.float32)


def test_sample_lights_matches_jax(scenes):
    """Rect and sphere lights' directions on 4,096 lanes, the inside-
    the-sphere branch included (every lane is inside the dome): within
    1e-5 relative."""
    scene_j, scene = scenes
    p, u = _light_inputs(5)
    with jax.disable_jit():
        want = np.asarray(jlights.sample_lights(
            scene_j, jnp.asarray(p), *(jnp.asarray(x) for x in u)))
    got = lights.sample_lights(scene, torch.from_numpy(p),
                               *(torch.from_numpy(x) for x in u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    inside = np.linalg.norm(p - [0, 2, 0], axis=1) <= 2.0
    assert inside.sum() > 50 and (~inside).sum() > 50
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_lights_pdf_matches_jax(scenes):
    """The mixture pdf over the three lights at the sampled directions and
    at uniform ones: within 1e-5 relative; the dome's 1/4π is in every
    lane's sum."""
    scene_j, scene = scenes
    p, u = _light_inputs(6)
    wi = lights.sample_lights(scene, torch.from_numpy(p),
                              *(torch.from_numpy(x) for x in u)).numpy()
    r = np.random.default_rng(7)
    w2 = r.normal(size=(N, 3)).astype(np.float32)
    w2 /= np.linalg.norm(w2, axis=1, keepdims=True)
    for w in (wi, w2):
        with jax.disable_jit():
            want = np.asarray(jlights.lights_pdf(scene_j, jnp.asarray(p),
                                                 jnp.asarray(w)))
        got = lights.lights_pdf(scene, torch.from_numpy(p),
                                torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert (got >= 1.0 / (4.0 * np.pi) / 3.0 * (1 - 1e-6)).all()
