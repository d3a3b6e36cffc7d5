"""The port's train step: its loss and gradients against the JAX package's,
against finite differences of its own loss, and an inverse solve.

On the CPU every bounce of the port's train engine is the plain step
under autograd, which the CUDA kernels are held against on the card
(``tests/test_torch_kernel.py``, ``chip_smoke.py``). The JAX side runs its
train engine with ``SRT_TPU_PALLAS=interpret``: the forward Pallas kernel
and the backward Pallas kernel, in interpret mode.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from _torch_scenes import LIT_ROOM_CAMERA, lit_room

import jax
import jax.numpy as jnp

from srt_tpu.diff import image_loss as jax_image_loss
from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.render.regen_scan import steps_for as jax_steps_for
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu_torch import convert, get_scene, make_train_step
from srt_tpu_torch.diff.inverse import (camera_rays, image_loss,
                                        render_pixels, splice)
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.render.camera import Camera
from srt_tpu_torch.render.regen_scan import steps_for, trace_queue
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import SceneFlags

torch.set_num_threads(1)

LOSS = dict(width=8, height=8, spp=4, max_depth=4)
# 3 bounces a step on a 128-lane wavefront: the 256 rays of LOSS start in
# two waves, so the second bounce regenerates lanes
SHORT = dict(wavefront=128, depth_budget=1.0, drain=1)


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _lit_room():
    return (lit_room(SceneBuilder()).build("cpu"),
            Camera.look_at(**LIT_ROOM_CAMERA, device="cpu"))


def test_loss_and_gradients_match_jax(flush_denormals, monkeypatch):
    """lit_room at 8x8, 4 spp, depth 4, params ``{tex_color, mat_params}``,
    a constant 0.3 target, on the pattern of ``test_diff.py:295-335``: the
    loss within 1e-4 relative, the gradients within rtol 2e-3 (the JAX
    package's kernel-backward bound) plus 1e-6. The step budget is cut to
    three bounces (``SHORT``; paths beyond are truncated alike on both
    sides): each launch of the JAX backward kernel in interpret mode takes
    some 30 s of CPU."""
    monkeypatch.setenv("SRT_TPU_PALLAS", "interpret")
    monkeypatch.delenv("SRT_TPU_BWD_KERNEL", raising=False)
    jax.clear_caches()
    scene_j = lit_room(JaxSceneBuilder()).build()
    cam_j = JaxCamera.look_at(**LIT_ROOM_CAMERA)
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    n = LOSS["width"] * LOSS["height"]
    target = np.full((n, 3), 0.3, np.float32)

    loss_j, g_j = jax.value_and_grad(lambda p: jax_image_loss(
        p, scene_j, cam_j, target, jnp.arange(n, dtype=jnp.int32), seed=7,
        engine_kw=SHORT, **LOSS))({"tex_color": scene_j.tex_color,
                  "mat_params": scene_j.mat_params})

    params = convert.params_from_arrays(
        {k: np.asarray(scene_j._asdict()[k])
         for k in ("tex_color", "mat_params")}, device="cpu")
    for v in params.values():
        v.requires_grad_()
    loss = image_loss(params, scene, cam, torch.from_numpy(target),
                      torch.arange(n), seed=7, engine_kw=SHORT, **LOSS)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-4 * float(loss_j)
    for k in params:
        want = np.asarray(g_j[k])
        np.testing.assert_allclose(params[k].grad.numpy(), want, rtol=2e-3,
                                   atol=1e-6, err_msg=k)
    assert np.abs(np.asarray(g_j["mat_params"])).sum() > 0.0


def test_gradients_match_finite_differences(flush_denormals):
    """The port's gradient against central differences of its own loss
    with common random numbers (``test_diff.py:36-61``): the two most
    influential ``tex_color`` rows, and the Beckmann alpha with the largest
    gradient. The alpha moves the sampled direction, so this case shows
    the gradient goes through the sample. Bound as the JAX test's: 3e-3
    plus 5% of the difference quotient."""
    scene, cam = _lit_room()
    pix = torch.arange(LOSS["width"] * LOSS["height"])
    with torch.no_grad():
        target = render_pixels(scene, cam, pix, seed=99, **LOSS)

    def loss(tc, mp):
        return image_loss({"tex_color": tc, "mat_params": mp}, scene, cam,
                          target, pix, seed=7, **LOSS)

    tc = scene.tex_color.clone().requires_grad_()
    mp = scene.mat_params.clone().requires_grad_()
    loss(tc, mp).backward()
    g_tc, g_mp = tc.grad.numpy(), mp.grad.numpy()

    def fd(base, other, index, eps, first):
        delta = torch.zeros_like(base)
        delta[index] = eps
        with torch.no_grad():
            args = ((base + delta, other), (base - delta, other))
            if not first:
                args = tuple(a[::-1] for a in args)
            return (float(loss(*args[0])) - float(loss(*args[1]))) / (2 * eps)

    checked = 0
    for i in np.argsort(np.abs(g_tc).sum(1))[-2:]:
        for c in range(3):
            q = fd(scene.tex_color, scene.mat_params, (i, c), 3e-3, True)
            assert abs(q - g_tc[i, c]) < 3e-3 + 0.05 * abs(q), (i, c, q)
            checked += 1
    beck = np.flatnonzero(scene.mat_type.numpy() == 2)
    m = beck[np.argmax(np.abs(g_mp[beck, 0]))]
    q = fd(scene.mat_params, scene.tex_color, (m, 0), 1e-3, False)
    assert abs(g_mp[m, 0]) > 1e-3
    assert abs(q - g_mp[m, 0]) < 3e-3 + 0.05 * abs(q), (m, q, g_mp[m, 0])
    assert checked == 6


def test_inverse_recovers_albedo():
    """Adam steps of ``make_train_step`` on the CPU pull a wrong wall
    colour towards the true one (``test_diff.py:90-115`` at a small size:
    an Oren–Nayar box, 12x12, 8 spp, depth 3)."""
    b = SceneBuilder()
    red = b.oren_nayar(b.constant((0.65, 0.05, 0.05)), 0.0)
    white = b.oren_nayar(b.constant((0.73, 0.73, 0.73)), 0.0)
    light = b.diffuse_light(b.constant((10.0, 10.0, 10.0)))
    b.yz_rect(0, 10, 0, 10, 10, red, flip=True)
    b.xz_rect(0, 10, 0, 10, 0, white)
    b.light_rect(b.xz_rect(3, 7, 3, 7, 9.9, light, flip=True))
    scene = b.build("cpu")
    cam = Camera.look_at(lookfrom=(5, 5, -12), lookat=(5, 3, 5), vfov=45.0,
                         aspect=1.0, device="cpu")
    kw = dict(width=12, height=12, spp=8, max_depth=3)
    with torch.no_grad():
        target = render_pixels(scene, cam, torch.arange(144), seed=0, **kw)
    true_red = scene.tex_color[0].clone()
    wrong = scene.tex_color.clone()
    wrong[0] = torch.tensor([0.3, 0.3, 0.6])
    step = make_train_step(scene, cam, {"tex_color": wrong}, lr=5e-2,
                           device="cpu", **kw)
    def off():
        return float((step.params["tex_color"][0].detach() - true_red)
                     .abs().sum())
    start = off()
    losses = [float(step(target, it)) for it in range(20)]
    end = off()
    assert np.isfinite(losses).all()
    assert end < 0.5 * start, (start, end)


def test_splice_refuses_geometry_and_the_atlas():
    """What splice and the train step refused is taken now: the image
    atlas (A13; splice drops its packed twin, as JAX's does) and the
    sharded step (A11, here on a one-process mesh); the scan engine (A6)
    renders the pixels, an unknown engine or field raises; geometric
    fields are accepted: splice sets them, the train step optimises them,
    and a sphere-centre parameter makes the spheres moving for the
    forward kernel."""
    from srt_tpu_torch.dist import make_mesh
    scene, cam = _lit_room()
    spliced = splice(scene, {"atlas": scene.atlas})
    assert spliced.atlas_u32 is None and scene.atlas_u32 is not None
    step = make_train_step(scene, cam, {"atlas": scene.atlas}, device="cpu",
                           **LOSS)
    assert torch.isfinite(step(torch.full((8, 8, 3), 0.3), 0))
    with pytest.raises(KeyError, match="atlas_f32"):
        splice(scene, {"atlas_f32": scene.atlas})
    for key in ("sph_center0", "sph_radius", "rect_k"):
        moved = getattr(scene, key) + 0.5
        assert torch.equal(getattr(splice(scene, {key: moved}), key), moved)
        step = make_train_step(scene, cam, {key: getattr(scene, key)},
                               device="cpu", **LOSS)
        assert step.params[key].requires_grad
        assert step.flags.moving == (key == "sph_center0")
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           mesh=make_mesh(device="cpu"), **LOSS)
    assert torch.isfinite(step(torch.full((8, 8, 3), 0.3), 0))
    px = render_pixels(scene, cam, torch.arange(4), engine="scan", seed=0,
                       **LOSS)
    assert px.shape == (4, 3) and torch.isfinite(px).all()
    with pytest.raises(ValueError, match="engine"):
        render_pixels(scene, cam, torch.arange(4), engine="lockstep",
                      seed=0, **LOSS)


def test_trace_queue_matches_a_full_trace():
    """With the bias-free budget (``drain=None``) the queue engine, 512
    rays through a 128-lane wavefront that regenerates, gives every ray
    the radiance of tracing it alone to the depth cap (the port's form of
    ``test_regen.py:48-81``), and starts every ray."""
    scene, cam = _lit_room()
    flags = SceneFlags.of(scene)
    tables = kb.build_tables(scene, flags)
    spec = kb.StepSpec(max_depth=8)
    r = np.random.default_rng(6)
    (o, d, t), salt = camera_rays(cam, torch.from_numpy(
        r.integers(0, 64 * 64, 512)), 1, width=64, height=64, seed=2)
    with torch.no_grad():
        out, started = trace_queue(
            scene, flags, tables, (o, d, t), salt, wavefront=128, spec=spec,
            n_steps=steps_for(512, 128, 6.0, 8, drain=None))
        st = dict(o=o, d=d, time=t, beta=torch.ones_like(o),
                  radiance=torch.zeros_like(o), salt=salt,
                  alive=torch.ones(512, dtype=torch.bool),
                  depth=torch.zeros(512, dtype=torch.int32))
        for _ in range(spec.max_depth):
            st = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
            st["alive"] = st["alive"] & (st["depth"] < spec.max_depth)
    assert torch.equal(started, torch.ones(512))
    assert (st["radiance"] != 0).any(dim=1).sum() > 50
    torch.testing.assert_close(out, st["radiance"], rtol=0, atol=0)


def test_steps_for_matches_jax():
    """76 bounces a step at the slice's configuration (256x256, 4 spp,
    wavefront 16,384, budget 4.0, drain 12)."""
    assert steps_for(262144, 16384, 4.0, 50, drain=12) == 76
    for args in ((256, 8192, 4.0, 4, 12), (1000, 300, 2.5, 50, None),
                 (1152, 8192, 4.0, 3, 12)):
        assert steps_for(*args[:4], drain=args[4]) == jax_steps_for(
            *args[:4], drain=args[4])


def test_entry_points_default_to_the_card():
    """Without a ``device`` the entry points put their tensors on the card;
    on a machine without one they raise torch's own error, never fall back
    to the CPU."""
    scene, cam = _lit_room()
    calls = {
        "get_scene": lambda: get_scene("ball_scenes")[0].sph_radius,
        "SceneBuilder.build": lambda: lit_room(SceneBuilder()).build()
        .sph_radius,
        "Camera.look_at": lambda: Camera.look_at(**LIT_ROOM_CAMERA).origin,
        "convert.params_from_arrays": lambda: convert.params_from_arrays(
            {"tex_color": np.ones((2, 3))})["tex_color"],
        "make_train_step": lambda: make_train_step(
            scene, cam, {"tex_color": scene.tex_color}, **LOSS)
        .params["tex_color"],
    }
    for name, call in calls.items():
        if torch.cuda.is_available():
            assert call().device.type == "cuda", name
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
