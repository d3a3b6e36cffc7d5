"""The train step on the rich families against the JAX package: the port's
bounce gradient on scenes with checker and noise textures, image
textures, sphere lights, the specular branch and media, which kernel B5's
rich instantiation (``csrc/bounce_bwd.cu``, ``kRich``) differentiates on
the card.

The JAX side is ``jax.vjp`` of ``pallas/bounce_vjp.bounce_step_auto`` with
``interpret=True`` and frozen geometry: its backward Pallas kernel
(``fused_bounce_bwd``) in interpret mode, and XLA differentiating the
deferred noise and image epilogue, as ``tests/test_torch_diff.py`` holds
the lean scenes. The port's side is its plain backward, ``torch.autograd``
of the plain step, which the CUDA kernel is held against on the card
(``chip_smoke.py`` phase 19). Lanes whose two forwards part (XLA
contracts multiply-adds, ROADMAP C5) are excluded as there, at most
``ALIVE_MISMATCH`` of them. This file holds the checker and the marble
(``two_spheres``, ``two_perlin_spheres``);
``tests/test_torch_train_rich_image.py`` the image-albedo scenes
(``earth_sphere``, the media room) with the same check, so that the two
halves of JAX's interpret-mode cost run on two workers. Finite
differences of the train step's loss on the same scenes, and the hybrid
on ``random_scene``, are in ``tests/test_torch_train_rich_steps.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings

from _torch_census import bounce_census
from _torch_scenes import LIT_ROOM_CAMERA, lit_room_media

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.pallas.bounce_vjp import bounce_step_auto
from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.scene import library as jlib
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu_torch import convert
from srt_tpu_torch.diff.inverse import camera_rays
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.scene.ir import SceneFlags
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:asset .* missing")

ROWS = ("o", "d", "beta", "radiance")
# the families each scene's state must hand the backward
FAMILIES = {"two_spheres": ("checker", "sphere_light_sample"),
            "two_perlin_spheres": ("marble", "sphere_light_sample"),
            "earth_sphere": ("image", "sphere_light_sample"),
            "lit_room_media": ("medium", "specular", "image")}


@pytest.fixture
def flush_denormals():
    # XLA's CPU backend flushes float32 denormals; do the same here
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@functools.lru_cache(maxsize=None)
def _scenes(name: str):
    """(JAX scene, port scene, port camera, port flags): JAX's scene
    converted field by field, so both packages read the same tables."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if name == "lit_room_media":
            scene_j = lit_room_media(JaxSceneBuilder()).build()
            cam_j = JaxCamera.look_at(**LIT_ROOM_CAMERA)
        else:
            scene_j, cam_j, _ = jlib.get_scene(name, aspect=1.0)
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    return scene_j, scene, cam, SceneFlags.of(scene)


def _mid_flight(scene, cam, flags, n_live: int, n_dead: int) -> dict:
    """Camera rays of a 64x64, 2 spp image in a seeded order, one plain
    bounce, then ``n_live`` lanes still alive and ``n_dead`` dead ones."""
    n = 8192
    rays, salt = camera_rays(cam, torch.arange(64 * 64), 2, width=64,
                             height=64, seed=0)
    keep = torch.from_numpy(np.random.default_rng(0).permutation(n))
    st = dict(o=rays[0][keep], d=rays[1][keep], time=rays[2][keep],
              beta=torch.ones((n, 3)), radiance=torch.zeros((n, 3)),
              alive=torch.ones(n, dtype=torch.bool), salt=salt[keep],
              depth=torch.zeros(n, dtype=torch.int32))
    spec = kb.StepSpec(max_depth=50)
    with torch.no_grad():
        st = kb.bounce_step_ref(scene, flags, kb.build_tables(
            scene, flags)["mat"], st, spec)
    alive = np.flatnonzero(st["alive"].numpy())
    dead = np.flatnonzero(~st["alive"].numpy())
    assert len(alive) >= n_live and len(dead) >= n_dead
    idx = torch.from_numpy(np.sort(np.concatenate([alive[:n_live],
                                                   dead[:n_dead]])))
    return {k: v[idx].contiguous() for k, v in st.items()}


@pytest.mark.parametrize("name", ["two_spheres", "two_perlin_spheres"])
def test_rich_bounce_backward_matches_jax_kernel(name, flush_denormals,
                                                 monkeypatch):
    monkeypatch.delenv("SRT_TPU_BWD_KERNEL", raising=False)
    check_rich_backward(name)


def check_rich_backward(name: str) -> None:
    """1,024 mid-flight lanes (768 alive, 256 dead) of each scene and a
    seeded cotangent: the port's plain backward against ``jax.vjp`` of
    the JAX kernel bounce, ``d_state`` lane by lane and the
    ``mat_params``/``tex_color``/``tex_color2`` cotangents as sums. Bound:
    ``utils/contract.py``'s, rtol 2e-3 (the JAX package's kernel-backward
    bound) plus 1e-5 of the largest entry, on the lanes whose forwards
    agree, at most ``GRAD_FRAC`` of them beyond it (a hit on a
    1000-radius sphere cancels in ``b * b - c``, where XLA contracts
    multiply-adds, C5: one lane of two_perlin_spheres' ground, 0.3% off in
    ``d``). The cotangent of o, d and beta is zero where the bounce ends
    the path, as in the engine. Each state holds lanes of the scene's
    families."""
    scene_j, scene, cam, flags = _scenes(name)
    flags_j = JaxSceneFlags.of(scene_j)
    st = _mid_flight(scene, cam, flags, 768, 256)
    c = bounce_census(scene, st["o"], st["d"], st["time"], st["salt"],
                      st["depth"], st["alive"])
    assert all(c[f] for f in FAMILIES[name]), c
    n = st["o"].shape[0]
    spec = kb.StepSpec(max_depth=50)
    st_np = {k: v.numpy() for k, v in st.items()}
    st_np["salt"] = st_np["salt"].view(np.uint32)

    def f(sc, rows):
        out = bounce_step_auto(sc, dict(st_np, **rows), 50, 1 << 30, flags_j,
                               1e-9, True, True)
        return {k: out[k] for k in ROWS}, out["alive"]
    out_j, vjp, alive_j = jax.vjp(
        f, scene_j, {k: jnp.asarray(st_np[k]) for k in ROWS}, has_aux=True)
    out_j = {k: np.asarray(v) for k, v in out_j.items()}

    params = {k: getattr(scene, k).clone().requires_grad_()
              for k in ("mat_params", "tex_color", "tex_color2")}
    tables = kb.build_tables(dataclasses.replace(scene, **params), flags)
    with torch.no_grad():
        out_t = kb.bounce_step_ref(scene, flags, tables["mat"], st, spec)
    alive = out_t["alive"].numpy()
    near = lambda k, tol: (np.abs(out_j[k] - out_t[k].numpy())  # noqa: E731
                           .max(-1) <= tol)
    agree = ((np.asarray(alive_j) == alive) & near("radiance", 1e-3)
             & (~alive | (near("d", 1e-4) & near("beta", 1e-3))))
    assert 1.0 - agree.mean() <= contract.ALIVE_MISMATCH, agree.mean()

    r = np.random.default_rng(3)
    ct = {k: (r.standard_normal((n, 3)) * agree[:, None]).astype(np.float32)
          for k in ROWS}
    for k in ("o", "d", "beta"):
        ct[k] *= alive[:, None]
    d_scene, d_st = vjp({k: jnp.asarray(v) for k, v in ct.items()})
    d_state, d_mat = kbb.bounce_bwd_reference(
        scene, flags, tables["mat"], st,
        {k: torch.from_numpy(v) for k, v in ct.items()}, spec)
    tables["mat"].backward(d_mat)

    m = contract.check_grads({k: np.asarray(d_st[k]) for k in ROWS},
                             {k: d_state[k].numpy() for k in ROWS})
    assert m["finite"]
    for k, p in params.items():
        want = np.asarray(getattr(d_scene, k))
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   rtol=contract.GRAD_RTOL,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    assert np.abs(np.asarray(d_scene.tex_color)).sum() > 0.0
