"""The port's bounce against the JAX package's, lane by lane.

Inputs come from numpy with fixed seeds and go through both packages.
Tolerances are the per-bounce contract of ``srt_tpu_torch.utils.contract``
(the JAX package's own kernel-against-XLA bounds). Two facts about the CPU
backends shape these tests:

* XLA's CPU backend flushes float32 denormals to zero, PyTorch keeps them
  by default, so a lane whose throughput underflows below 1.2e-38 dies in
  one and lives in the other: the tests flush denormals in PyTorch too.
* Inside jitted code XLA contracts multiply-adds into fused multiply-adds;
  PyTorch's eager operations round each product. On Beckmann lanes that
  ulp-level difference moves a few percent of directions beyond 1e-4 (the
  Newton solve of the VNDF sampler amplifies it). Run op by op, without
  jit, the JAX functions agree with the port far more tightly, which
  ``test_*_op_by_op`` pins down.
"""
from __future__ import annotations

import functools
import warnings

from _torch_scenes import LIT_ROOM_CAMERA, lit_room

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srt_tpu.core.rng import RaySampler
from srt_tpu.core.sobol import sobol_points as jsobol
from srt_tpu.materials.microfacet import sample_wh_visible as jvndf
from srt_tpu.pallas.bounce import fused_regen_bounce
from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.render.integrator import bounce_step as jbounce
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu.scene.library import ball_scenes
from srt_tpu_torch import convert
from srt_tpu_torch.core.sobol import sobol_points
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.materials.microfacet import sample_wh_visible
from srt_tpu_torch.render.integrator import bounce_step
from srt_tpu_torch.scene.ir import SceneFlags
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@functools.lru_cache(maxsize=None)
def _scenes(name: str):
    """(JAX scene, JAX camera, JAX flags, port scene, port camera, port
    flags) for one scene, the port's converted from the JAX tables."""
    if name == "ball_scenes":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            scene_j, cam_j, _ = ball_scenes(aspect=1.0)
    else:
        scene_j = lit_room(JaxSceneBuilder()).build()
        cam_j = JaxCamera.look_at(**LIT_ROOM_CAMERA)
    arrays = {k: (None if v is None else np.asarray(v))
              for k, v in scene_j._asdict().items()}
    scene = convert.scene_from_arrays(arrays, device="cpu")
    cam = convert.camera_from_arrays(
        {k: np.asarray(v) for k, v in cam_j._asdict().items()}, device="cpu")
    return scene_j, cam_j, JaxSceneFlags.of(scene_j), scene, cam, \
        SceneFlags.of(scene)


@pytest.fixture
def scenes():
    return _scenes("ball_scenes")


def _primary_state(cam_j, n: int, seed: int) -> dict:
    """Primary-ray wavefront state from numpy (JAX RaySampler salts)."""
    r = np.random.default_rng(seed)
    pix = r.integers(0, 512 * 512, n).astype(np.int32)
    samp = r.integers(0, 16, n).astype(np.int32)
    s, t = (r.uniform(size=n).astype(np.float32) for _ in range(2))
    sampler = RaySampler.create(0, pix, samp)
    ray = cam_j.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                     sampler.uniform(34))
    return {k: np.asarray(v) for k, v in dict(
        o=ray.origin, d=ray.direction, time=ray.time,
        beta=np.ones((n, 3), np.float32),
        radiance=np.zeros((n, 3), np.float32), alive=np.ones(n, bool),
        salt=sampler.salt, depth=np.zeros(n, np.int32)).items()}


def _to_torch(state: dict) -> dict:
    out = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    out["salt"] = torch.from_numpy(state["salt"].astype(np.int64))
    return out


def _numpy(state: dict) -> dict:
    return {k: np.asarray(v) for k, v in state.items()}


@pytest.mark.parametrize("name", ["ball_scenes", "lit_room"])
def test_bounce_step_matches_xla(name, flush_denormals):
    """The plain bounce against JAX's jitted XLA ``bounce_step``, 4096
    lanes over 3 bounces, advancing along the XLA trajectory (the pattern
    of tests/test_fused_bounce.py:105-169). ``lit_room`` adds misses, two
    lights, an image-textured rect emitter and a flipped sphere."""
    scene_j, cam_j, flags_j, scene, _, flags = _scenes(name)
    state = _primary_state(cam_j, 4096, 0)
    step = jax.jit(functools.partial(jbounce, max_depth=8, rr_start=1 << 30,
                                     flags=flags_j))
    for _ in range(3):
        a = _numpy(step(scene_j, state))
        b = bounce_step(scene, _to_torch(state), 8, 1 << 30, flags)
        contract.check_bounce(a, {k: v.numpy() for k, v in b.items()})
        np.testing.assert_array_equal(b["depth"].numpy(), a["depth"])
        state = a


def test_vndf_sampler_matches_op_by_op():
    """Beckmann VNDF sampling against the JAX function called op by op:
    no multiply-add contraction on either side."""
    r = np.random.default_rng(1)
    n = 20000
    wo = r.normal(size=(n, 3)).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2])
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    ax, ay, u1, u2 = (r.uniform(1e-3, 1.0, n).astype(np.float32)
                      for _ in range(4))
    with jax.disable_jit():
        want = np.asarray(jvndf(*(jnp.asarray(x)
                                  for x in (wo, ax, ay, u1, u2))))
    got = sample_wh_visible(*(torch.from_numpy(x)
                              for x in (wo, ax, ay, u1, u2))).numpy()
    diff = np.abs(got - want).max(-1)
    assert (diff > 1e-6).mean() < 2e-3, (diff > 1e-6).mean()
    assert diff.max() < 1e-3, diff.max()


def test_trajectory_matches_op_by_op(scenes, flush_denormals):
    """Four bounces of 2048 lanes along each package's own trajectory,
    JAX op by op: the live-lane counts and the radiance agree, so the
    plain bounce computes the reference's estimator, not a neighbour."""
    scene_j, cam_j, flags_j, scene, _, flags = scenes
    state_j = _primary_state(cam_j, 2048, 2)
    state_t = _to_torch(state_j)
    live_j = live_t = 0
    for _ in range(4):
        with jax.disable_jit():
            state_j = _numpy(jbounce(scene_j, state_j, 50, 1 << 30, flags_j))
        state_t = bounce_step(scene, state_t, 50, 1 << 30, flags)
        live_j += int(state_j["alive"].sum())
        live_t += int(state_t["alive"].sum())
    assert abs(live_j - live_t) <= 2, (live_j, live_t)
    rad_j, rad_t = state_j["radiance"], state_t["radiance"].numpy()
    assert (np.abs(rad_j - rad_t).max(-1) > 1e-4).mean() < 2e-3
    np.testing.assert_allclose(rad_t.mean(), rad_j.mean(), rtol=1e-4)


def test_regen_step_matches_pallas_interpret(scenes, flush_denormals):
    """One ``regen_bounce_reference`` step against the JAX regen kernel
    (``fused_regen_bounce``, Pallas interpret mode) on a two-tile, 8192-lane
    wavefront about half dead: work-queue ranks, pixels, salts, depths,
    the cursor and the finished mask exact; floats under the per-bounce
    contract."""
    scene_j, cam_j, flags_j, scene, cam, flags = scenes
    n, w, spp, depth = 8192, 128, 4, 8
    spec = kb.RegenSpec(width=w, height=w, spp=spp, max_depth=depth,
                        rr_start=1 << 30, pdf_floor=1e-9, seed=3)
    jitter = sobol_points(spp, 2).astype(np.float32)
    inp = kb.RegenInputs(scene, flags, cam, torch.from_numpy(jitter))
    st = kb.new_wavefront(n, "cpu")
    st["cursor"].fill_(spec.total_work // 4)      # rows with spheres
    for _ in range(3):
        kb.regen_bounce_reference(inp, st, spec)
    st["alive"][torch.from_numpy(np.random.default_rng(4).random(n) < .35)] = 0
    st["dead"].copy_(kb.count_dead(st["alive"]))
    assert 0.4 < float((st["alive"] == 0).float().mean()) < 0.6
    assert int(st["cursor"][0]) + n < spec.total_work

    planes = {}
    for k, jk in (("o", "o"), ("d", "d"), ("beta", "b"), ("radiance", "r")):
        for c, axis in enumerate("xyz"):
            planes[jk + axis] = jnp.asarray(st[k][c].numpy().reshape(-1, 128))
    for k in ("time", "salt", "depth", "alive", "pix"):
        planes[k] = jnp.asarray(st[k].numpy().reshape(-1, 128))
    planes["cursor"] = jnp.asarray(st["cursor"].numpy())
    step = jax.jit(functools.partial(
        fused_regen_bounce, max_depth=depth, rr_start=1 << 30,
        flags=flags_j, pdf_floor=1e-9, width=w, height=w, spp=spp,
        total_work=spec.total_work, n_lanes=n, interpret=True))
    sobol_tab = jnp.asarray(jsobol(spp, 2), jnp.float32).T
    out = {k: np.asarray(v).reshape(-1) for k, v in
           step(scene_j, planes, cam_j, sobol_tab, spec.seed).items()}

    kb.regen_bounce_reference(inp, st, spec)
    for k in ("pix", "salt", "depth", "fin"):
        np.testing.assert_array_equal(st[k].numpy(), out[k], err_msg=k)
    assert int(st["cursor"][0]) == int(out["cursor"][0])
    want = {"alive": out["alive"] != 0,
            **{k: np.stack([out[jk + a] for a in "xyz"], -1)
               for k, jk in (("d", "d"), ("beta", "b"), ("radiance", "r"))}}
    contract.check_bounce(want, contract.wavefront_arrays(st))
