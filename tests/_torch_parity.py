"""Shared inputs of the parity tests: a library scene in both packages
(the port's converted from the JAX tables, bit for bit), a camera-ray
wavefront made by JAX's sampler, and the per-bounce comparison of the
port's plain parity bounce with JAX's, lane by lane."""
from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from srt_tpu_torch import convert
from srt_tpu_torch.scene.ir import SceneFlags

SEED_STATE = 0


@functools.lru_cache(maxsize=None)
def scenes(name: str):
    """(JAX scene, JAX camera, port scene, port camera) of a library scene."""
    from srt_tpu.scene.library import get_scene as jax_get_scene
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene_j, cam_j, _ = jax_get_scene(name, aspect=1.0)
    scene = convert.scene_from_arrays(
        {k: (None if v is None else np.asarray(v))
         for k, v in scene_j._asdict().items()}, device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    return scene_j, cam_j, scene, cam


def parity_flags(scene_j, scene, no_stale: bool = False):
    """Both packages' flags with the parity estimator switched on."""
    from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
    sw = dict(ref_parity=True, parity_no_stale=no_stale)
    return (JaxSceneFlags.of(scene_j)._replace(**sw),
            SceneFlags.of(scene)._replace(**sw))


def camera_state(cam_j, n: int) -> dict:
    """``n`` camera rays over a 64x64 grid of the image from JAX's sampler
    (the pattern of ``tests/test_fused_bounce.py:285-299``), with a zero
    ``stale`` plane, as numpy."""
    from srt_tpu.core.rng import RaySampler
    pix = np.arange(n, dtype=np.int32)
    samp = np.zeros(n, np.int32)
    s = (pix % 64).astype(np.float32) / 64.0
    t = (pix // 64 % 64).astype(np.float32) / 64.0
    sampler = RaySampler.create(0, pix, samp)
    rays = cam_j.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                      sampler.uniform(34))
    return {k: np.asarray(v) for k, v in dict(
        o=rays.origin, d=rays.direction, time=rays.time,
        beta=np.ones((n, 3), np.float32),
        radiance=np.zeros((n, 3), np.float32), alive=np.ones(n, bool),
        salt=sampler.salt, depth=np.zeros(n, np.int32),
        stale=np.zeros(n, np.float32)).items()}


def to_torch(state: dict) -> dict:
    out = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    out["salt"] = torch.from_numpy(state["salt"].astype(np.int64))
    return out


def numpy_state(state: dict) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in state.items()}


def plain_hit(scene, state: dict, flags):
    """The port's plain triangle walk as the external hit, None without
    triangles."""
    from srt_tpu_torch.render.intersect import intersect_tris
    if not scene.n_tris:
        return None
    return intersect_tris(scene, state["o"], state["d"],
                          leaf_size=flags.bvh_leaf)


def check_parity_bounces(name: str, no_stale: bool, n: int = 4096,
                         n_kernel: int = 1024) -> tuple[dict, dict]:
    """The port's plain parity bounce against JAX's jitted XLA
    ``bounce_step`` on ``n`` camera-ray lanes over three bounces along
    JAX's trajectory, then one bounce of ``n_kernel`` of the second
    bounce's lanes against ``fused_bounce(interpret=True)``, JAX's parity
    kernel; the per-bounce contract with ``stale`` each time (on a
    triangle scene the port's bounce takes its plain walk's hit). Returns
    the parity census summed over the three bounces, and the kernel
    bounce's."""
    import jax

    from srt_tpu.pallas.bounce import fused_bounce
    from srt_tpu.render.integrator import bounce_step as jbounce
    from srt_tpu_torch.render.integrator import bounce_step
    from srt_tpu_torch.utils import contract
    from _torch_census import parity_census

    scene_j, cam_j, scene, _ = scenes(name)
    flags_j, flags = parity_flags(scene_j, scene, no_stale)
    state = camera_state(cam_j, n)
    step = jax.jit(functools.partial(jbounce, max_depth=8, rr_start=1 << 30,
                                     flags=flags_j))

    def port(state):
        st = to_torch(state)
        tri = plain_hit(scene, st, flags)
        return (parity_census(scene, flags, st, tri),
                numpy_state(bounce_step(scene, st, 8, 1 << 30, flags,
                                        tri=tri)))

    census, mid = [], None
    for i in range(3):
        a = numpy_state(step(scene_j, state))
        c, b = port(state)
        census.append(c)
        contract.check_bounce(a, b)
        np.testing.assert_array_equal(b["depth"], a["depth"])
        if i == 1:
            mid = state
        state = a
    part = {k: v[:n_kernel] for k, v in mid.items()}
    kstep = jax.jit(functools.partial(fused_bounce, max_depth=8,
                                      rr_start=1 << 30, flags=flags_j,
                                      interpret=True))
    want = numpy_state(kstep(scene_j, part))
    c_kernel, got = port(part)
    contract.check_bounce(want, got)
    return {k: sum(c[k] for c in census) for k in census[0]}, c_kernel


def lit_floor(b):
    """``tests/test_render.py:274-300``'s scene in builder ``b`` (either
    package's): an Oren–Nayar floor under a bright emissive dome that is
    not an NEE light, and a weak rect light, the only one. Parity lights
    diffuse surfaces only through NEE, so its floor is several times
    darker."""
    ground = b.oren_nayar(b.constant((0.6, 0.6, 0.6)), 0.5)
    b.xz_rect(-50, 50, -50, 50, 0, ground)
    b.sphere((0, 0, 0), 500.0, b.diffuse_light(b.constant((1.0, 1.0, 1.0))),
             env=True)
    lid = b.xz_rect(-2, 2, -2, 2, 30,
                    b.diffuse_light(b.constant((0.5, 0.5, 0.5))), flip=True)
    b.light_rect(lid)
    return b


LIT_FLOOR_CAMERA = dict(lookfrom=(0, 8, -20), lookat=(0, 0, 0), vfov=40.0,
                        aspect=1.0)


def images(scene_j, cam_j, scene, cam, parity: bool, op_by_op=False,
           **cfg):
    """The JAX package's ``render_regen`` (its XLA bounce on the CPU;
    ``op_by_op``: run without jit, so XLA contracts no multiply-add,
    ROADMAP C5) and the port's on the same scene and settings, as
    numpy."""
    import contextlib

    import jax

    from srt_tpu import RenderConfig as JaxRenderConfig
    from srt_tpu.render.regen import render_regen as jax_render_regen
    from srt_tpu_torch import RenderConfig, render_regen
    eager = jax.disable_jit() if op_by_op else contextlib.nullcontext()
    with warnings.catch_warnings(), eager:
        warnings.simplefilter("ignore")
        img_j = np.asarray(jax_render_regen(
            scene_j, cam_j, JaxRenderConfig(ref_parity=parity, **cfg)))
    img = render_regen(scene, cam, RenderConfig(ref_parity=parity, **cfg))
    return img_j, img.numpy()
