"""The sphere winner (plain version of kernel B6), the differentiable
assembly of the winner's hit and the moving-sphere sweep, against the JAX
package: ``sphere_winner_pallas`` in Pallas interpret mode,
``intersect_spheres_via_pallas``, the XLA sweep ``intersect_spheres`` and
``jax.vjp`` of ``_assemble_sphere_hit``.

The port takes the motion lerp's factor with the reciprocal of the shutter
span, as the JAX kernels do (``pallas/spheres.py:150-154``); the JAX XLA
sweep and assembly divide (``intersect.py:105-106,257-258``), so against
those ``t`` agrees to rounding, within the bounds of
``tests/test_pallas.py:147-157``. On ball_scenes' rays from the camera,
some 760 units from the balls, the quadratic's ``b*b - c`` cancels, and
XLA's contraction of it into a fused multiply-add on the CPU (ROADMAP C5)
moves ``t`` by up to 1e-4 relative: there ``t`` is held to 1e-4.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from srt_tpu.core.ray import Ray
from srt_tpu.pallas.spheres import sphere_winner_pallas
from srt_tpu.render.intersect import (_assemble_sphere_hit,
                                      intersect_spheres,
                                      intersect_spheres_via_pallas)
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.library import ball_scenes
from srt_tpu_torch import convert
from srt_tpu_torch.render.intersect import (assemble_sphere_hit,
                                            intersect_scene, sphere_winner)

torch.set_num_threads(1)


def _convert(scene_j):
    return convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")


@functools.lru_cache(maxsize=None)
def _moving_scene():
    """20 spheres, every fourth moving and every fourth flipped, in a
    50-radius env dome (``tests/test_pallas.py:116-157``), and 1,500
    seeded rays with seeded times."""
    rng = np.random.default_rng(11)
    b = JaxSceneBuilder()
    m = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    for i in range(20):
        c = rng.uniform(-4, 4, 3)
        if i % 4 == 0:
            b.sphere(c, 0.5, m, center1=c + rng.uniform(-1, 1, 3))
        else:
            b.sphere(c, 0.5, m, flip=i % 4 == 1)
    b.sphere((0, 0, 0), 50.0, b.diffuse_light(b.constant((1, 1, 1))),
             env=True)
    scene_j = b.build()
    n = 1500
    o = (rng.standard_normal((n, 3)) * 2).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0, 1, n).astype(np.float32)
    return scene_j, _convert(scene_j), (o, d, t), 2e-5


@functools.lru_cache(maxsize=None)
def _ball_rays():
    """ball_scenes and 1,024 rays from its camera's position towards
    seeded points of its ball field, at seeded times."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene_j, cam_j, _ = ball_scenes(aspect=1.0)
    rng = np.random.default_rng(3)
    n = 1024
    o = np.repeat(np.asarray(cam_j.origin, np.float32)[None], n, 0)
    aim = np.stack([rng.uniform(0, 560, n), rng.uniform(0, 40, n),
                    rng.uniform(-110, 460, n)], 1).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0, 1, n).astype(np.float32)
    return scene_j, _convert(scene_j), (o, d.astype(np.float32), t), 1e-4


def _cases():
    return (_moving_scene(), _ball_rays())


def _torch_rays(rays):
    return tuple(torch.from_numpy(x) for x in rays)


def test_winner_matches_the_pallas_kernel():
    """Plain ``sphere_winner`` against ``sphere_winner_pallas`` in
    interpret mode: the index equal, ``t`` within 2e-5 (relative and
    absolute, ``test_pallas.py:152``; 1e-4 on ball_scenes, see above), on
    the moving, flipped and env spheres and on ball_scenes rays."""
    for scene_j, scene, rays, tol in _cases():
        t_j, k_j = sphere_winner_pallas(scene_j, Ray(*rays), 1e-3,
                                        interpret=True)
        t, k = sphere_winner(scene, *_torch_rays(rays))
        assert k.dtype == torch.int32
        np.testing.assert_array_equal(k.numpy(), np.asarray(k_j))
        np.testing.assert_allclose(t.numpy(), np.asarray(t_j), rtol=tol,
                                   atol=2e-5)
        assert int((k >= 0).sum()) > 100


def test_winner_marks_misses():
    """A ray that meets no sphere gets ``idx`` -1 and ``t`` 3e38; ties keep
    the lower index."""
    b = JaxSceneBuilder()
    m = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    b.sphere((0.0, 0.0, 5.0), 1.0, m)
    b.sphere((0.0, 0.0, 5.0), 1.0, m)
    scene = _convert(b.build())
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    t, k = sphere_winner(scene, o, d, torch.zeros(2))
    assert k.tolist() == [0, -1]
    assert t.tolist() == [4.0, float(np.float32(3e38))]


def test_assembled_hit_matches_the_jax_assembly():
    """``assemble_sphere_hit`` on the plain winner against
    ``intersect_spheres_via_pallas(interpret=True)`` with
    ``test_pallas.py:147-157``'s bounds (``t`` as above)."""
    for scene_j, scene, rays, tol in _cases():
        hp = intersect_spheres_via_pallas(scene_j, Ray(*rays), 1e-3,
                                          interpret=True)
        o, d, t = _torch_rays(rays)
        h = assemble_sphere_hit(scene, o, d, t, 1e-3,
                                sphere_winner(scene, o, d, t)[1])
        _assert_hits_close(h, hp, tol)


def _assert_hits_close(h, hj, tol=2e-5):
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(hj.hit))
    both = np.asarray(hj.hit)
    assert both.sum() > 100
    np.testing.assert_allclose(h.t.numpy()[both], np.asarray(hj.t)[both],
                               rtol=tol, atol=2e-5)
    np.testing.assert_array_equal(h.mat.numpy()[both],
                                  np.asarray(hj.mat)[both])
    np.testing.assert_allclose(h.normal.numpy()[both],
                               np.asarray(hj.normal)[both], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.uv.numpy()[both], np.asarray(hj.uv)[both],
                               rtol=2e-4, atol=2e-4)


def test_moving_sweep_matches_xla():
    """The lerped chunk sweep (``intersect_scene`` on a sphere-only scene)
    against JAX's ``intersect_spheres``; and the sweep's hit equals the
    hit assembled from its winner, bit for bit."""
    scene_j, scene, rays, _ = _moving_scene()
    hx = intersect_spheres(scene_j, Ray(*rays), 1e-3, 3e38)
    o, d, t = _torch_rays(rays)
    h = intersect_scene(scene, o, d, 1e-3, time=t)
    _assert_hits_close(h, hx)
    ha = intersect_scene(scene, o, d, 1e-3, time=t,
                         sph=sphere_winner(scene, o, d, t))
    for a, b in zip(h, ha):
        assert torch.equal(a, b)
    # the lerp matters: the moving spheres' hits at time 0 differ
    h0 = intersect_scene(scene, o, d, 1e-3)
    assert not torch.equal(h0.t, h.t)


def test_assembly_cotangents_match_jax():
    """The assembly's cotangents in the spheres' centres and radii against
    ``jax.vjp(_assemble_sphere_hit)`` for the same winners and a seeded
    cotangent of ``t``, the position, the normal and the uv: within 1e-4
    relative, plus 1e-6 of the largest entry (the lerp factor is a product
    with the reciprocal here, a quotient there)."""
    for scene_j, scene, rays, _ in _cases():
        o, d, t = _torch_rays(rays)
        k = sphere_winner(scene, o, d, t)[1]
        hit = (k >= 0).numpy()
        r = np.random.default_rng(7)
        n = len(k)
        cts = [r.standard_normal(s).astype(np.float32) * hit.reshape(
            (n,) + (1,) * (len(s) - 1)) for s in ((n,), (n, 3), (n, 3),
                                                  (n, 2))]

        def f(c0, rad):
            h = _assemble_sphere_hit(
                scene_j._replace(sph_center0=c0, sph_radius=rad),
                Ray(*rays), 1e-3, jnp.asarray(k.numpy()))
            return (jnp.where(h.hit, h.t, 0.0), h.p, h.normal, h.uv)

        _, vjp = jax.vjp(f, scene_j.sph_center0, scene_j.sph_radius)
        want = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c)
                                                 for c in cts))]
        c0 = scene.sph_center0.clone().requires_grad_()
        rad = scene.sph_radius.clone().requires_grad_()
        sc = dataclasses.replace(scene, sph_center0=c0, sph_radius=rad)
        h = assemble_sphere_hit(sc, o, d, t, 1e-3, k)
        outs = (torch.where(h.hit, h.t, 0.0), h.p, h.normal, h.uv)
        got = torch.autograd.grad(outs, (c0, rad),
                                  [torch.from_numpy(c) for c in cts])
        for g, w in zip(got, want):
            assert np.abs(w).max() > 0.0
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-6 * np.abs(w).max())
