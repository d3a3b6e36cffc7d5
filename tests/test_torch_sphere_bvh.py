"""The sphere BVH against the JAX package (``srt_tpu/scene/build.py:
399-426``, ``srt_tpu/render/intersect.py:143-230``) and against the port's
own sphere sweep: the builder's tables to the bit, the walk's hits within
JAX's own tolerances (``tests/test_intersect.py:141-185``), the
gradients of the re-assembled hit, a plain-bounce render with the switch
on against JAX's under ``SRT_TPU_SPHERE_BVH=on``, and the refusal to walk
a tree whose spheres are being optimised.

Two scenes: JAX's own 80-sphere test scene (moving, flipped and plain
spheres inside an environment dome) and a 200-sphere seeded field on
random_scene's ground (``tests/_torch_scenes.py:sphere_field``)."""
from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_scenes import SPHERE_FIELD_CAMERA, sphere_field

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu import render as jax_render
from srt_tpu.core.ray import Ray
from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.render.intersect import \
    intersect_spheres_bvh as jax_intersect_spheres_bvh
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu_torch import RenderConfig, convert, make_train_step, render
from srt_tpu_torch.render import intersect
from srt_tpu_torch.render.intersect import (intersect_scene,
                                            intersect_spheres_bvh,
                                            sphere_bvh_winner,
                                            sphere_winner)
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import SceneFlags
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)

TABLES = ("sbvh_lo", "sbvh_hi", "sbvh_skip", "sbvh_first", "sbvh_count",
          "sbvh_ids", "sph_env_ids")
N_RAYS = 2000
RENDER = dict(width=16, height=16, spp=2, max_depth=4, sample_chunk=2)


def jax_test_scene(b):
    """JAX's sphere-BVH test scene (``tests/test_intersect.py:150-162``):
    80 spheres of radius 0.4 in [-8, 8]^3, every fifth moving, every fifth
    from the second flipped, and an environment dome of radius 100."""
    rng = np.random.default_rng(5)
    m = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    for i in range(80):
        c = rng.uniform(-8, 8, 3)
        if i % 5 == 0:
            b.sphere(c, 0.4, m, center1=c + rng.uniform(-1, 1, 3))
        elif i % 5 == 1:
            b.sphere(c, 0.4, m, flip=True)
        else:
            b.sphere(c, 0.4, m)
    b.sphere((0, 0, 0), 100.0, b.diffuse_light(b.constant((1, 1, 1))),
             env=True)
    return b


CASES = {"jax80": jax_test_scene, "field200": lambda b: sphere_field(b, 200)}


def _both(case: str):
    """(port scene from the port's builder, JAX scene, JAX's tables
    converted)."""
    fill = CASES[case]
    scene_j = fill(JaxSceneBuilder()).build()
    want = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    return fill(SceneBuilder()).build("cpu"), scene_j, want


def _rays(case: str):
    """JAX's seeded rays (``tests/test_intersect.py:166-171``): origins
    N(0, 16 I), unit directions, times in [0, 1); over the field the
    origins are lifted above its ground."""
    rng = np.random.default_rng(5 if case == "jax80" else 6)
    o = rng.standard_normal((N_RAYS, 3)).astype(np.float32) * 4
    if case == "field200":
        o[:, 1] = np.abs(o[:, 1]) + np.float32(0.6)
    d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = rng.uniform(0, 1, N_RAYS).astype(np.float32)
    return o, d, time


def _sweep(scene, o, d, time):
    """The port's brute sphere sweep (``intersect_scene`` without the
    switch) over the scene's spheres alone."""
    no_rects = {k: getattr(scene, k)[:0] for k in
                ("rect_axis", "rect_bounds", "rect_k", "rect_mat",
                 "rect_flip")}
    return intersect_scene(dataclasses.replace(scene, **no_rects), o, d,
                           1e-3, time=time)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_equal_jax(case):
    """The builder's sphere BVH and dome ids equal JAX's to the bit, and
    the flags' ``sbvh_leaf`` equals JAX's."""
    got, scene_j, want = _both(case)
    for k in TABLES:
        a, b = getattr(got, k), getattr(want, k)
        assert a is not None and b is not None, k
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert got.sph_env_ids.numel() == (1 if case == "jax80" else 0)
    assert SceneFlags.of(got).sbvh_leaf == JaxSceneFlags.of(scene_j).sbvh_leaf


def test_no_tree_below_the_threshold():
    """63 spheres and a dome: no tree (JAX's threshold counts the spheres
    that are not domes); 64: a tree."""
    for n, built in ((63, False), (64, True)):
        b = SceneBuilder()
        m = b.lambertian(b.constant((0.5, 0.5, 0.5)))
        for i in range(n):
            b.sphere((float(i), 0.0, 0.0), 0.4, m)
        b.sphere((0, 0, 0), 100.0, m, env=True)
        scene = b.build("cpu")
        assert all((getattr(scene, k) is not None) == built for k in TABLES)
        assert SceneFlags.of(scene).sbvh_leaf == 4


def _assert_close(h, ref, both, loose):
    """JAX's tolerances on the lanes both hit: ``t`` 2e-5 absolute plus
    2e-5 relative and normal 2e-4; on the ``loose`` lanes ``t`` within 1e-4
    relative, where JAX's contracted multiply-adds (C5) show: long rays,
    and the ground's radius of 1,000, whose ``|oc|^2 - r^2`` cancels two
    numbers near 1e6 (a float32 step there is 0.0625)."""
    t, t_ref = np.asarray(h.t), np.asarray(ref.t)
    np.testing.assert_allclose(t[both], t_ref[both], rtol=1e-4, atol=2e-5)
    near = both & ~loose
    np.testing.assert_allclose(t[near], t_ref[near], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(h.normal)[both],
                               np.asarray(ref.normal)[both],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_jax_and_the_sweep(case):
    """On 2,000 seeded rays the walk's hit equals JAX's walk's and the
    port's sweep's (hit, material), its winner the sweep's winner (index)
    on every lane whose sweep winner is not a dome, and ``t`` and normal
    agree within JAX's tolerances."""
    scene, scene_j, _ = _both(case)
    o, d, time = _rays(case)
    ot, dt, tt = (torch.from_numpy(x) for x in (o, d, time))
    h = intersect_spheres_bvh(scene, ot, dt, tt)
    sweep = _sweep(scene, ot, dt, tt)
    hj = jax_intersect_spheres_bvh(
        scene_j, Ray(origin=jnp.asarray(o), direction=jnp.asarray(d),
                     time=jnp.asarray(time)), 1e-3, 3e38)
    k, visits = sphere_bvh_winner(scene, ot, dt, tt, stats=True)
    ground = (scene.sph_radius[k.clamp(min=0).long()] > 10.0).numpy()
    for ref, loose in ((sweep, np.zeros_like(ground)),
                       (hj, ground | (np.asarray(hj.t) > 10.0))):
        np.testing.assert_array_equal(np.asarray(h.hit), np.asarray(ref.hit))
        both = np.asarray(h.hit)
        np.testing.assert_array_equal(np.asarray(h.mat)[both],
                                      np.asarray(ref.mat)[both])
        _assert_close(h, ref, both, loose)
    assert 0.2 < float(h.hit.float().mean())
    _, k_sweep = sphere_winner(scene, ot, dt, tt)
    dome = torch.zeros(scene.n_spheres + 1, dtype=torch.bool)
    dome[scene.sph_env_ids.long()] = True
    swept_dome = dome[k_sweep.long()]
    assert torch.equal(k[~swept_dome], k_sweep[~swept_dome])
    assert bool((k[swept_dome] == -1).all())
    assert int(visits.min()) >= 1
    assert int(visits.max()) < scene.sbvh_skip.shape[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_the_sweep(case):
    """The summed hit ``t`` differentiated through the walk's re-assembled
    hit and through the sweep: the same ``sph_radius`` and
    ``sph_center0`` gradients, and on every lane the same gradient with
    respect to its ray's origin and direction."""
    scene, _, _ = _both(case)
    o, d, time = (torch.from_numpy(x) for x in _rays(case))
    grads = []
    for walk in (True, False):
        leaves = {k: getattr(scene, k).clone().requires_grad_()
                  for k in ("sph_radius", "sph_center0")}
        s = dataclasses.replace(scene, **leaves)
        oo, dd = o.clone().requires_grad_(), d.clone().requires_grad_()
        h = (intersect_spheres_bvh(s, oo, dd, time) if walk
             else _sweep(s, oo, dd, time))
        loss = torch.where(h.hit, h.t, 0.0).sum()
        grads.append(torch.autograd.grad(
            loss, [leaves["sph_radius"], leaves["sph_center0"], oo, dd]))
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert float(grads[0][0].abs().sum()) > 0.0


def test_plain_render_matches_jax(monkeypatch):
    """The 200-sphere field at 16^2 x 2 spp x depth 4 through the plain
    bounce with the switch on against JAX's scan engine under
    ``SRT_TPU_SPHERE_BVH=on`` (its ``intersect_scene`` traced afresh),
    within the image contract; the walk ran, and the image also agrees
    with the port's swept one."""
    scene, scene_j, _ = _both("field200")
    cam_j = JaxCamera.look_at(**SPHERE_FIELD_CAMERA)
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    calls = []
    walk = intersect.sphere_bvh_winner

    def counted(*a, **kw):
        calls.append(1)
        return walk(*a, **kw)

    monkeypatch.setattr(intersect, "sphere_bvh_winner", counted)
    img = render(scene, cam, RenderConfig(**RENDER, sphere_bvh=True),
                 plain=True).numpy()
    assert len(calls) == RENDER["max_depth"]
    swept = render(scene, cam, RenderConfig(**RENDER), plain=True).numpy()
    assert len(calls) == RENDER["max_depth"]
    monkeypatch.setenv("SRT_TPU_SPHERE_BVH", "on")
    jax.clear_caches()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            img_j = np.asarray(jax_render(scene_j, cam_j,
                                          JaxRenderConfig(**RENDER)))
    finally:
        jax.clear_caches()
    assert np.isfinite(img).all() and float(img.mean()) > 0.0
    contract.check_image(img, img_j)
    contract.check_image(img, swept)


def test_switch_refuses_optimised_sphere_geometry():
    """With the switch on, a sphere geometry parameter of the train step
    and a sphere geometry tensor that requires a gradient in
    ``intersect_scene`` raise; a colour parameter steps."""
    scene, _, _ = _both("field200")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in
         JaxCamera.look_at(**SPHERE_FIELD_CAMERA)._asdict().items()},
        device="cpu")
    kw = dict(width=4, height=4, spp=1, max_depth=2, device="cpu",
              sphere_bvh=True)
    for k in ("sph_radius", "sph_center0"):
        with pytest.raises(ValueError, match="sphere"):
            make_train_step(scene, cam, {k: getattr(scene, k)}, **kw)
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color}, **kw)
    assert step.flags.sphere_bvh
    assert np.isfinite(float(step(torch.full((4, 4, 3), 0.3), 0)))
    o, d, time = (torch.from_numpy(x[:8]) for x in _rays("field200"))
    live = dataclasses.replace(
        scene, sph_radius=scene.sph_radius.clone().requires_grad_())
    with pytest.raises(ValueError, match="stale"):
        intersect_scene(live, o, d, 1e-3, time=time, sphere_bvh=True)
    intersect_scene(live, o, d, 1e-3, time=time)
