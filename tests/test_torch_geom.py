"""Geometry in the train step: moving spheres in the bounce, the hybrid
backward's cotangents in the spheres' centres and radii and the rects'
planes, and the train step on a triangle scene.

The JAX side is ``fused_bounce`` in Pallas interpret mode for the forward,
``jax.vjp`` of its XLA ``bounce_step`` (run op by op) for the per-bounce
cotangents, and ``image_loss`` with ``SRT_TPU_PALLAS=interpret`` for the
cornell_boxes loss. The port's side is its plain bounce and its hybrid
backward on the CPU (the sphere winner from the plain version of kernel
B6), which the kernels are held against on the card (``chip_smoke.py``
phases 13-16, ``tests/test_torch_kernel.py``). The scenes are Lambertian
and Oren–Nayar: JAX's XLA linearisation and its kernel backward part on
Beckmann material cotangents (ROADMAP C2), not on these. Finite
differences take the port's own plain bounce and loss with common random
numbers.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_scenes import LIT_ROOM_CAMERA

from srt_tpu.core.rng import RaySampler
from srt_tpu.diff import image_loss as jax_image_loss
from srt_tpu.pallas.bounce import fused_bounce
from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.render.integrator import bounce_step as jbounce
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu.scene.library import cornell_boxes as jax_cornell_boxes
from srt_tpu_torch import convert, get_scene, make_train_step
from srt_tpu_torch.core import rng
from srt_tpu_torch.diff.inverse import image_loss, render_pixels
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.kernels import bounce_vjp as kv
from srt_tpu_torch.render.camera import Camera
from srt_tpu_torch.render.integrator import DIM_MIX
from srt_tpu_torch.render.intersect import intersect_scene, sphere_winner
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import SceneFlags
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)

ROWS = ("o", "d", "beta", "radiance")
GEOM = ("sph_center0", "sph_radius", "rect_k")


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def sphere_room(b, moving: bool = False):
    """Fill builder ``b`` (either package's): Lambertian and Oren–Nayar
    spheres on an Oren–Nayar floor under one rect light; with ``moving``
    every other sphere rises 0.5 over the shutter interval."""
    light = b.diffuse_light(b.constant((8.0, 8.0, 8.0)))
    floor = b.oren_nayar(b.constant((0.5, 0.5, 0.5)), 20.0)
    lam = b.lambertian(b.constant((0.7, 0.3, 0.2)))
    on = b.oren_nayar(b.constant((0.2, 0.6, 0.3)), 10.0)
    top = b.xz_rect(-2, 2, -2, 2, 5, light, flip=True)
    b.xz_rect(-10, 10, -10, 10, 0, floor)
    for i in range(4):
        c = (2.0 * i - 3.0, 1.0, 0.0)
        kw = ({"center1": (c[0], c[1] + 0.5, c[2])}
              if moving and i % 2 == 0 else {})
        b.sphere(c, 0.8, lam if i % 2 else on, **kw)
    b.light_rect(top)
    return b


@functools.lru_cache(maxsize=None)
def _room(moving: bool):
    scene_j = sphere_room(JaxSceneBuilder(), moving).build()
    cam_j = JaxCamera.look_at(**LIT_ROOM_CAMERA)
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    return scene_j, cam_j, scene


def _state(cam_j, n: int, seed: int) -> dict:
    """Camera rays through the lower two thirds of the film at seeded
    times: numpy arrays, JAX salts as uint32."""
    r = np.random.default_rng(seed)
    pix = r.integers(0, 64 * 64, n).astype(np.int32)
    samp = r.integers(0, 4, n).astype(np.int32)
    s = r.uniform(size=n).astype(np.float32)
    t = r.uniform(0.0, 0.66, n).astype(np.float32)
    sampler = RaySampler.create(seed, pix, samp)
    ray = cam_j.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                     sampler.uniform(34))
    return {k: np.asarray(v) for k, v in dict(
        o=ray.origin, d=ray.direction, time=ray.time,
        beta=np.ones((n, 3), np.float32),
        radiance=np.zeros((n, 3), np.float32), alive=np.ones(n, bool),
        salt=sampler.salt, depth=np.zeros(n, np.int32)).items()}


def _port(st: dict) -> dict:
    out = {k: torch.from_numpy(np.array(st[k])) for k in
           ("o", "d", "time", "beta", "radiance", "alive", "depth")}
    out["salt"] = torch.from_numpy(st["salt"].view(np.int32).copy())
    return out


def test_moving_bounce_matches_fused_bounce(flush_denormals):
    """One bounce on the moving room: the plain B2 against JAX's
    ``fused_bounce`` with ``flags.moving`` (Pallas interpret mode) under
    the per-bounce contract, depth exact; and the lerp matters."""
    scene_j, cam_j, scene = _room(True)
    flags_j, flags = JaxSceneFlags.of(scene_j), SceneFlags.of(scene)
    assert flags_j.moving and flags.moving
    st = _state(cam_j, 2048, 0)
    want = {k: np.asarray(v) for k, v in jax.jit(functools.partial(
        fused_bounce, max_depth=8, rr_start=1 << 30, flags=flags_j,
        interpret=True))(scene_j, st).items()}
    tables = kb.build_tables(scene, flags)
    got = kb.bounce_fwd(scene, flags, tables, _port(st),
                        kb.StepSpec(max_depth=8))
    np.testing.assert_array_equal(got["depth"].numpy(), want["depth"])
    contract.check_bounce(want, {k: v.numpy() for k, v in got.items()})
    still = kb.bounce_step_ref(_room(False)[2], flags, tables["mat"],
                               _port(st), kb.StepSpec(max_depth=8))
    assert int((still["d"] != got["d"]).any(1).sum()) > 50


def _cotangent(n: int, ends: np.ndarray, agree: np.ndarray, seed: int):
    r = np.random.default_rng(seed)
    ct = {k: (r.standard_normal((n, 3)) * agree[:, None]).astype(np.float32)
          for k in ROWS}
    for k in ("o", "d", "beta"):
        ct[k] *= ~ends[:, None]
    return ct


@functools.lru_cache(maxsize=None)
def _bounced_state():
    """The static room after one jitted XLA bounce from the camera (the
    lanes on the spheres, the floor and the light), 1,024 lanes; numpy
    arrays, not to be written."""
    scene_j, cam_j, scene = _room(False)
    st = jax.jit(functools.partial(jbounce, max_depth=50, rr_start=1 << 30,
                                   flags=JaxSceneFlags.of(scene_j)))(
        scene_j, _state(cam_j, 1024, 1))
    return {k: np.asarray(v) for k, v in st.items()}


def test_hybrid_cotangents_match_jax_vjp(flush_denormals, monkeypatch):
    """The hybrid backward's per-bounce cotangents in the rows and in
    ``sph_center0``, ``sph_radius`` and ``rect_k`` against ``jax.vjp`` of
    JAX's ``bounce_step`` on the same state and cotangent: the rows lane
    by lane under the gradient contract, the geometric sums within its
    2e-3 relative plus 1e-5 of the largest entry. The cotangent sits on
    the lanes that took the light sample: JAX's XLA bounce detaches the
    BSDF sample (``integrator.py:280``), which the port's backward, like
    JAX's backward kernel, differentiates (ROADMAP C2), so on the other
    lanes the two linearisations part by design; the finite-difference
    test holds those. Lanes whose two forwards part (the per-bounce
    contract's near ties) carry no cotangent either, at most
    ALIVE_MISMATCH of them."""
    monkeypatch.delenv("SRT_TPU_PALLAS", raising=False)
    scene_j, _, scene = _room(False)
    flags_j, flags = JaxSceneFlags.of(scene_j), SceneFlags.of(scene)
    st = _bounced_state()
    n = len(st["alive"])
    spec = kb.StepSpec(max_depth=50)
    state = _port(st)

    def f(c0, rad, k, rows):
        sc = scene_j._replace(sph_center0=c0, sph_radius=rad, rect_k=k)
        out = jbounce(sc, dict(st, **rows), 50, 1 << 30, flags_j, 1e-9)
        return {k2: out[k2] for k2 in ROWS}, out["alive"]
    out_j, vjp, alive_j = jax.vjp(
        f, scene_j.sph_center0, scene_j.sph_radius, scene_j.rect_k,
        {k: jnp.asarray(st[k]) for k in ROWS}, has_aux=True)
    out_j = {k: np.asarray(v) for k, v in out_j.items()}
    alive_j = np.asarray(alive_j)
    tables = kb.build_tables(scene, flags)
    with torch.no_grad():
        out_t = kb.bounce_step_ref(scene, flags, tables["mat"], state, spec)
    alive = out_t["alive"].numpy()

    def near(k, tol):
        return np.abs(out_j[k] - out_t[k].numpy()).max(-1) <= tol
    agree = ((alive_j == alive) & near("radiance", 1e-3)
             & (~alive | (near("d", 1e-4) & near("beta", 1e-3))))
    assert 1.0 - agree.mean() <= contract.ALIVE_MISMATCH
    salt = rng.hash_combine(rng.as_word(state["salt"]),
                            rng.as_word(state["depth"]))
    light = (rng.uniform(salt, DIM_MIX) < 0.5).numpy()
    assert 0.4 < light.mean() < 0.6
    ct = _cotangent(n, ~alive, agree & light, 3)
    d_c0, d_rad, d_k, d_rows = vjp({k: jnp.asarray(v) for k, v in
                                    ct.items()})
    geom = {k: getattr(scene, k) for k in GEOM}
    d_state, _, d_geom = kv.hybrid_vjp(
        scene, flags, tables, state, {k: torch.from_numpy(v)
                                      for k, v in ct.items()}, spec, geom)
    contract.check_grads({k: np.asarray(d_rows[k]) for k in ROWS},
                         {k: d_state[k].numpy() for k in ROWS}, frac=0.0)
    for name, want in zip(GEOM, (d_c0, d_rad, d_k)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0.0, name
        np.testing.assert_allclose(d_geom[name].numpy(), want,
                                   rtol=contract.GRAD_RTOL,
                                   atol=contract.GRAD_ATOL
                                   * np.abs(want).max(), err_msg=name)


def _winners(scene, state):
    hit = intersect_scene(scene, state["o"], state["d"], time=state["time"])
    k = sphere_winner(scene, state["o"], state["d"], state["time"])[1]
    return torch.where(hit.hit, hit.mat * 1000 + k.long(), -1)


def test_hybrid_cotangents_match_finite_differences(flush_denormals):
    """The hybrid's cotangents in single entries of ``sph_center0``,
    ``sph_radius`` and ``rect_k`` (the light's plane; the floor's would
    move the floor across the rays that start on it) against central
    differences of ``sum(ct * bounce)`` over the lanes whose winner and
    alive flag agree at +-eps and whose outputs move by little (a light
    sample crossing the light's edge jumps the mixture pdf): the others
    carry no cotangent. Within 1e-3 plus 2% of the quotient."""
    _, _, scene = _room(False)
    flags = SceneFlags.of(scene)
    state = _port(_bounced_state())
    spec = kb.StepSpec(max_depth=50)
    tables = kb.build_tables(scene, flags)
    n = state["alive"].shape[0]
    eps = 1e-2
    cases = [("sph_center0", (1, 0)), ("sph_center0", (2, 1)),
             ("sph_center0", (3, 2)), ("sph_radius", (0,)),
             ("sph_radius", (2,)), ("rect_k", (0,))]
    checked = 0
    for name, index in cases:
        outs = []
        for sign in (1.0, -1.0, 0.0):
            v = getattr(scene, name).clone()
            v[index] += sign * eps
            sc = dataclasses.replace(scene, **{name: v})
            with torch.no_grad():
                out = kb.bounce_step_ref(sc, flags, tables["mat"], state,
                                         spec)
            outs.append((out, _winners(sc, state)))
        (op, wp), (om, wm), (o0, w0) = outs
        smooth = [((op[k] - om[k]).abs().amax(1)
                   <= 0.05 * o0[k].abs().amax(1) + 1e-3) for k in ROWS]
        agree = ((wp == w0) & (wm == w0) & (op["alive"] == o0["alive"])
                 & (om["alive"] == o0["alive"]) & smooth[0] & smooth[1]
                 & smooth[2] & smooth[3]).numpy()
        assert agree.mean() > 0.9, (name, index, agree.mean())
        ct = _cotangent(n, ~o0["alive"].numpy(), agree, 5)
        ctt = {k: torch.from_numpy(v) for k, v in ct.items()}
        fd = sum(float((ctt[k] * (op[k] - om[k])).sum()) for k in ROWS) \
            / (2 * eps)
        _, _, d_geom = kv.hybrid_vjp(scene, flags, tables, state, ctt, spec,
                                     {name: getattr(scene, name)})
        an = float(d_geom[name][index])
        assert abs(fd - an) < 1e-3 + 0.02 * abs(fd), (name, index, fd, an)
        checked += abs(an) > 1e-2
    assert checked >= 4


def _lamp_room():
    """Ground (a sphere of radius 1000) seen from above and a rect light 6
    up that the camera does not see, the only rect: the image depends
    smoothly on its height ``rect_k[0]``."""
    b = SceneBuilder()
    white = b.oren_nayar(b.constant((0.7, 0.7, 0.7)), 10.0)
    glow = b.diffuse_light(b.constant((40.0, 40.0, 40.0)))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, white)
    b.light_rect(b.xz_rect(1, 2, -0.5, 0.5, 6.0, glow, flip=True))
    cam = Camera.look_at(lookfrom=(0, 5, -5), lookat=(0, 0, 0), vfov=30.0,
                         aspect=1.0, device="cpu")
    return b.build("cpu"), cam


LAMP = dict(width=8, height=8, spp=4, max_depth=2)
LAMP_ENGINE = dict(wavefront=256, depth_budget=2.0, drain=1)


def test_light_height_gradient_matches_finite_differences():
    """The image loss's gradient in the light's ``rect_k`` (the port's form
    of ``test_diff.py:117-160``) against a central difference of the loss
    with common random numbers: within 1e-4 plus 10% of the quotient."""
    scene, cam = _lamp_room()
    pix = torch.arange(64)
    with torch.no_grad():
        target = render_pixels(scene, cam, pix, seed=11,
                               **LAMP, **LAMP_ENGINE) * 0.9

    def loss(k):
        return image_loss({"rect_k": k}, scene, cam, target, pix, seed=7,
                          engine_kw=LAMP_ENGINE, **LAMP)
    k = scene.rect_k.clone().requires_grad_()
    loss(k).backward()
    an = float(k.grad[0])
    eps = 1e-2
    with torch.no_grad():
        dk = torch.tensor([eps])
        fd = (float(loss(scene.rect_k + dk)) - float(loss(scene.rect_k - dk))
              ) / (2 * eps)
    assert np.isfinite(k.grad.numpy()).all() and abs(an) > 1e-5
    assert abs(fd - an) < 1e-4 + 0.1 * abs(fd), (fd, an)


def test_inverse_recovers_light_height():
    """Adam steps of ``make_train_step`` with ``{"rect_k"}`` on the CPU
    pull a light placed 1.5 too high back: the error halves within 20
    steps. Every step renders with the target's seed (common random
    numbers), so the loss is least at the true height."""
    scene, cam = _lamp_room()
    with torch.no_grad():
        target = render_pixels(scene, cam, torch.arange(64), seed=0,
                               **LAMP, **LAMP_ENGINE)
    wrong = scene.rect_k.clone()
    wrong[0] += 1.5
    step = make_train_step(scene, cam, {"rect_k": wrong}, lr=0.1,
                           engine_kw=LAMP_ENGINE, device="cpu", **LAMP)

    def off():
        return abs(float(step.params["rect_k"][0]) - float(scene.rect_k[0]))
    start = off()
    losses = [float(step(target, 0)) for _ in range(20)]
    assert np.isfinite(losses).all()
    assert off() < 0.5 * start, (start, off())


def test_hybrid_material_cotangent_equals_the_kernel_backward():
    """Under frozen geometry on ball_scenes the hybrid (its sphere hit
    assembled from the winner) and ``BounceCore``'s backward (the plain
    sweep) give the same cotangents: rows and the (M, 14) table within
    1e-6 relative (the sums' order differs)."""
    scene, cam, _ = get_scene("ball_scenes", device="cpu")
    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=50)
    from srt_tpu_torch.diff.inverse import camera_rays
    (o, d, t), salt = camera_rays(cam, torch.arange(0, 4096, 8), 1,
                                  width=64, height=64, seed=3)
    st = dict(o=o, d=d, time=t, beta=torch.ones_like(o),
              radiance=torch.zeros_like(o), salt=salt,
              alive=torch.ones(512, dtype=torch.bool),
              depth=torch.zeros(512, dtype=torch.int32))
    with torch.no_grad():
        st = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    ends = ~kb.bounce_step_ref(scene, flags, tables["mat"], st,
                               spec)["alive"].numpy()
    ct = {k: torch.from_numpy(v) for k, v in
          _cotangent(512, ends, np.ones(512, bool), 9).items()}
    g_h, m_h, _ = kv.hybrid_vjp(scene, flags, tables, st, ct, spec, {})
    g_c, m_c = kbb.bounce_bwd(scene, flags, tables, st, ct, spec)
    assert float(m_c.abs().max()) > 0.0
    for k in ROWS:
        torch.testing.assert_close(g_h[k], g_c[k], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(m_h, m_c, rtol=1e-6,
                               atol=1e-6 * float(m_c.abs().max()))


def _ball_state(n: int = 64):
    scene, cam, _ = get_scene("ball_scenes", device="cpu")
    flags = SceneFlags.of(scene)
    from srt_tpu_torch.diff.inverse import camera_rays
    (o, d, t), salt = camera_rays(cam, torch.arange(n), 1, width=64,
                                  height=64, seed=3)
    st = dict(o=o, d=d, time=t, beta=torch.ones_like(o),
              radiance=torch.zeros_like(o), salt=salt,
              alive=torch.ones(n, dtype=torch.bool),
              depth=torch.zeros(n, dtype=torch.int32))
    return scene, flags, kb.build_tables(scene, flags), st


def test_bounce_step_auto_reads_the_geometry_from_requires_grad(monkeypatch):
    """The backward is chosen from the scene itself: kernel B5's when no
    geometric tensor requires a gradient and B5 covers the scene, else the
    hybrid over exactly the geometric tensors that require one."""
    scene, flags, tables, st = _ball_state()
    spec = kb.StepSpec(max_depth=50)
    took = []
    monkeypatch.setattr(kv, "bounce_core", lambda *a: took.append("B5"))
    monkeypatch.setattr(kv, "bounce_hybrid",
                        lambda *a: took.append(sorted(a[5])))
    rad = scene.sph_radius.clone().requires_grad_()
    tc = scene.tex_color.clone().requires_grad_()
    for sc, fl in ((dataclasses.replace(scene, tex_color=tc), flags),
                   (dataclasses.replace(scene, sph_radius=rad), flags),
                   (scene, flags._replace(moving=True))):
        kv.bounce_step_auto(sc, fl, tables, st, spec)
    assert took == ["B5", ["sph_radius"], []]


def test_bounce_bwd_refuses_what_the_kernel_lacks():
    """A direct call of B5's wrapper on a scene it cannot differentiate
    raises rather than return a wrong gradient: moving spheres (it replays
    static ones) and triangles (it has no external hit), through
    ``BounceCore`` as well."""
    scene, flags, tables, st = _ball_state()
    spec = kb.StepSpec(max_depth=50)
    ct = {k: torch.ones_like(st[k]) for k in ROWS}
    moving = flags._replace(moving=True)
    with pytest.raises(NotImplementedError, match="moving spheres"):
        kbb.bounce_bwd(scene, moving, tables, st, ct, spec)
    rows = {k: st[k].clone().requires_grad_() for k in ROWS}
    out = kv.bounce_core(scene, moving, tables, dict(st, **rows), spec)
    with pytest.raises(NotImplementedError, match="hybrid backward"):
        out["radiance"].sum().backward()
    tri, _, _ = get_scene("cornell_boxes", device="cpu")
    with pytest.raises(NotImplementedError, match="triangle"):
        kbb.bounce_bwd(tri, SceneFlags.of(tri), {}, st, ct, spec)


LOSS = dict(width=8, height=8, spp=2, max_depth=4)
SHORT = dict(wavefront=128, depth_budget=1.0, drain=1)


def test_cornell_loss_matches_jax_and_its_gradient_finite_differences(
        flush_denormals, monkeypatch):
    """The train step's loss on cornell_boxes (8x8, 2 spp, depth 4,
    ``{"tex_color"}`` towards a constant 0.3 image; B3's plain walk, the
    plain B2, the hybrid backward) against JAX ``image_loss`` with
    ``SRT_TPU_PALLAS=interpret`` (its triangle kernel and fused bounce in
    interpret mode): within 1e-4 relative. JAX's gradient on a triangle
    scene is out of reach on the CPU: its hybrid backward linearises the
    interpret-mode triangle kernel, which has no JVP, and its XLA walk is a
    ``while_loop`` with no reverse mode. So the port's ``tex_color``
    gradient is held against central differences of its own loss with
    common random numbers, on the two most influential rows, within 3e-3
    plus 5% of the quotient (``test_torch_train.py``'s bound). Three
    bounces a step (``SHORT``)."""
    monkeypatch.setenv("SRT_TPU_PALLAS", "interpret")
    jax.clear_caches()
    scene_j, cam_j, _ = jax_cornell_boxes(aspect=1.0)
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    n = LOSS["width"] * LOSS["height"]
    target = np.full((n, 3), 0.3, np.float32)
    loss_j = float(jax_image_loss(
        {"tex_color": scene_j.tex_color}, scene_j, cam_j, target,
        jnp.arange(n, dtype=jnp.int32), seed=5, engine_kw=SHORT, **LOSS))

    def loss(tc):
        return image_loss({"tex_color": tc}, scene, cam,
                          torch.from_numpy(target), torch.arange(n), seed=5,
                          engine_kw=SHORT, **LOSS)
    tc = scene.tex_color.clone().requires_grad_()
    value = loss(tc)
    value.backward()
    assert abs(value.item() - loss_j) <= 1e-4 * loss_j
    g = tc.grad.numpy()
    assert np.isfinite(g).all()
    eps = 3e-3
    for i in np.argsort(np.abs(g).sum(1))[-2:]:
        for c in range(3):
            delta = torch.zeros_like(tc)
            delta[i, c] = eps
            with torch.no_grad():
                q = (float(loss(scene.tex_color + delta))
                     - float(loss(scene.tex_color - delta))) / (2 * eps)
            assert abs(q - g[i, c]) < 3e-3 + 0.05 * abs(q), (i, c, q, g[i, c])
