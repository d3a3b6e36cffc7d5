"""The port's bounce gradient against the JAX package's backward kernel.

The JAX side is ``jax.vjp`` of ``pallas/bounce_vjp.bounce_step_auto`` with
``interpret=True`` and frozen geometry: its core runs the backward Pallas
kernel (``fused_bounce_bwd``) in interpret mode, and XLA differentiates
the deferred image-emission epilogue that the port folds into its bounce,
so both sides hold the same function. The port's side is its plain
backward, ``torch.autograd`` of the plain step, which the CUDA kernel is
held against on the card (``tests/test_torch_kernel.py``,
``chip_smoke.py``). The JAX kernel is jitted, and XLA contracts
multiply-adds there while PyTorch does not (ROADMAP C5); the few lanes
whose forward branches part because of it are excluded by zeroing their
cotangent on both sides, and the excluded share is bounded.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_scenes import LIT_ROOM_CAMERA, lit_room

from srt_tpu.pallas.bounce import _grad_safe_sqrt, _gsdiv
from srt_tpu.pallas.bounce_vjp import bounce_step_auto
from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.render.integrator import bounce_step as jbounce
from srt_tpu.core.rng import RaySampler
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu_torch import convert
from srt_tpu_torch.core.gradsafe import grad_safe_sqrt, gsdiv, gsrecip
from srt_tpu_torch.diff.inverse import adam, splice
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.scene.ir import SceneFlags
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)

ROWS = ("o", "d", "beta", "radiance")


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_grad_safe_helpers_keep_values_bit_for_bit():
    r = np.random.default_rng(0)
    x = np.concatenate([r.normal(size=4096) * 10.0 ** r.integers(-30, 30,
                                                                 4096),
                        [0.0, -0.0, 1e-38, -1e-38]]).astype(np.float32)
    y = np.concatenate([r.normal(size=4096),
                        [1e-20, -1e-20, 3.0, 1e-30]]).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    assert torch.equal(grad_safe_sqrt(xt), torch.sqrt(torch.clamp(xt, min=0)))
    assert torch.equal(gsdiv(xt, yt), xt / yt)
    assert torch.equal(gsrecip(yt), 1.0 / yt)
    assert torch.equal(gsdiv(2.5, yt), torch.full_like(yt, 2.5) / yt)


def test_grad_safe_helpers_give_finite_gradients():
    """On a masked lane (a zero cotangent) the plain forms' gradients are
    NaN: ``sqrt'(0) = inf`` and the division's coefficient ``-x / 1e-40``
    meet the zero, the torch form of the JAX package's minimal repro (the
    gradient of ``1 / max(x - 1, 1e-20)`` at ``x = 1``, ``bounce.py:127``).
    The helpers give 0 there, and JAX's helpers' gradients elsewhere."""
    y = torch.tensor([1e-20, 0.0], requires_grad=True)
    off = torch.tensor(False)

    def masked(div, sqrt):
        return (torch.where(off, div(2.0 * torch.ones(()),
                                     torch.clamp(y[0], min=1e-20)), 0.0)
                + torch.where(off, sqrt(y[1]), 0.0))
    g_plain, = torch.autograd.grad(
        masked(lambda a, b: a / b,
               lambda x: torch.sqrt(torch.clamp(x, min=0.0))), y)
    assert torch.isnan(g_plain).all()
    g_safe, = torch.autograd.grad(masked(gsdiv, grad_safe_sqrt), y)
    assert torch.equal(g_safe, torch.zeros(2))

    r = np.random.default_rng(1)
    num = r.normal(size=512).astype(np.float32)
    den = (r.normal(size=512) * 10.0 ** r.integers(-21, 3, 512)).astype(
        np.float32)
    jn, jd = jax.vmap(jax.grad(lambda a, b: _gsdiv(a, b), (0, 1)))(num, den)
    js = jax.vmap(jax.grad(_grad_safe_sqrt))(num)
    n_t = torch.from_numpy(num).requires_grad_()
    d_t = torch.from_numpy(den).requires_grad_()
    tn, td = torch.autograd.grad(gsdiv(n_t, d_t).sum(), (n_t, d_t))
    ts, = torch.autograd.grad(grad_safe_sqrt(n_t).sum(), n_t)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _lit_room():
    scene_j = lit_room(JaxSceneBuilder()).build()
    cam_j = JaxCamera.look_at(**LIT_ROOM_CAMERA)
    arrays = {k: (None if v is None else np.asarray(v))
              for k, v in scene_j._asdict().items()}
    return scene_j, cam_j, convert.scene_from_arrays(arrays, device="cpu")


def _mid_flight(scene_j, cam_j, n_live: int, n_dead: int) -> dict:
    """Camera rays through the lower two thirds of the film (the floor and
    the spheres), two jitted XLA bounces, then ``n_live`` lanes still
    alive and ``n_dead`` dead ones: numpy arrays."""
    r = np.random.default_rng(0)
    n = 8192
    pix = r.integers(0, 64 * 64, n).astype(np.int32)
    samp = r.integers(0, 4, n).astype(np.int32)
    s = r.uniform(size=n).astype(np.float32)
    t = r.uniform(0.0, 0.66, n).astype(np.float32)
    sampler = RaySampler.create(0, pix, samp)
    ray = cam_j.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                     sampler.uniform(34))
    st = dict(o=ray.origin, d=ray.direction, time=ray.time,
              beta=jnp.ones((n, 3)), radiance=jnp.zeros((n, 3)),
              alive=jnp.ones(n, bool), salt=sampler.salt,
              depth=jnp.zeros(n, jnp.int32))
    step = jax.jit(functools.partial(jbounce, max_depth=50,
                                     rr_start=1 << 30,
                                     flags=JaxSceneFlags.of(scene_j)))
    for _ in range(2):
        st = step(scene_j, st)
    st = {k: np.asarray(v) for k, v in st.items()}
    alive = np.flatnonzero(st["alive"])
    dead = np.flatnonzero(~st["alive"])
    assert len(alive) >= n_live and len(dead) >= n_dead
    keep = np.sort(np.concatenate([alive[:n_live], dead[:n_dead]]))
    return {k: v[keep] for k, v in st.items()}


def _port_state(st: dict) -> dict:
    out = {k: torch.from_numpy(np.array(st[k])) for k in
           ("o", "d", "time", "beta", "radiance", "alive", "depth")}
    out["salt"] = torch.from_numpy(st["salt"].view(np.int32).copy())
    return out


def test_bounce_backward_matches_jax_kernel(flush_denormals, monkeypatch):
    """1,024 mid-flight lit_room lanes (768 alive, 256 dead; misses, two
    rect lights, an image-textured emitter, Beckmann from near-mirror to
    rough, Oren–Nayar) and a seeded cotangent: the port's plain backward
    against ``jax.vjp`` of the JAX kernel bounce, ``d_state`` lane by lane
    and ``d_mat_params``/``d_tex_color`` as sums. Bound: rtol 2e-3, the
    JAX package's own kernel-backward bound (``test_diff.py:334-335``),
    plus 1e-5 of the largest entry; lanes where the two forwards part
    (alive, or ``d``/``beta``/radiance beyond the per-bounce contract) are
    excluded, at most ALIVE_MISMATCH of them. The cotangent of o, d and
    beta is zero where the bounce ends the path, as in the engine: the
    port's kernels leave a finished lane's beta as it was."""
    monkeypatch.delenv("SRT_TPU_BWD_KERNEL", raising=False)
    jax.clear_caches()
    scene_j, cam_j, scene = _lit_room()
    flags_j, flags = JaxSceneFlags.of(scene_j), SceneFlags.of(scene)
    st = _mid_flight(scene_j, cam_j, 768, 256)
    n = len(st["alive"])
    spec = kb.StepSpec(max_depth=50)

    def f(sc, rows):
        out = bounce_step_auto(sc, dict(st, **rows), 50, 1 << 30, flags_j,
                               1e-9, True, True)
        return {k: out[k] for k in ROWS}
    out_j, vjp = jax.vjp(f, scene_j, {k: jnp.asarray(st[k]) for k in ROWS})
    out_j = {k: np.asarray(v) for k, v in out_j.items()}

    params = {"mat_params": scene.mat_params.clone().requires_grad_(),
              "tex_color": scene.tex_color.clone().requires_grad_()}
    tables = kb.build_tables(splice(scene, params), flags)
    state = _port_state(st)
    with torch.no_grad():
        out_t = kb.bounce_step_ref(scene, flags, tables["mat"], state, spec)
    alive = out_t["alive"].numpy()

    # the lanes whose forward branches agree
    near = lambda k, tol: (np.abs(out_j[k] - out_t[k].numpy())  # noqa: E731
                           .max(-1) <= tol)
    jax_alive = np.asarray(bounce_step_auto(
        scene_j, st, 50, 1 << 30, flags_j, 1e-9, True, True)["alive"])
    agree = ((jax_alive == alive) & near("radiance", 1e-3)
             & (~alive | (near("d", 1e-4) & near("beta", 1e-3))))
    excluded = 1.0 - agree.mean()
    assert excluded <= contract.ALIVE_MISMATCH, excluded

    r = np.random.default_rng(3)
    ct = {k: (r.standard_normal((n, 3)) * agree[:, None]).astype(np.float32)
          for k in ROWS}
    for k in ("o", "d", "beta"):
        ct[k] *= alive[:, None]
    d_scene, d_st = vjp({k: jnp.asarray(v) for k, v in ct.items()})

    ct_t = {k: torch.from_numpy(v) for k, v in ct.items()}
    d_state, d_mat = kbb.bounce_bwd_reference(scene, flags, tables["mat"],
                                              state, ct_t, spec)
    tables["mat"].backward(d_mat)

    got = {k: d_state[k].numpy() for k in ROWS}
    want = {k: np.asarray(d_st[k]) for k in ROWS}
    m = contract.check_grads(want, got, frac=0.0)
    for name in ("mat_params", "tex_color"):
        a = np.asarray(getattr(d_scene, name))
        b = params[name].grad.numpy()
        np.testing.assert_allclose(b, a, rtol=contract.GRAD_RTOL,
                                   atol=1e-5 * np.abs(a).max(), err_msg=name)
    assert np.abs(np.asarray(d_scene.mat_params)).sum() > 0.0
    assert m["finite"]


def test_adam_matches_optax():
    """Two port Adam steps on given gradients against ``optax.adam(1e-2)``
    on the same gradients."""
    r = np.random.default_rng(4)
    p0 = r.normal(size=(5, 3)).astype(np.float32)
    grads = [r.normal(size=(5, 3)).astype(np.float32) * s
             for s in (1.0, 1e-3)]
    p = torch.from_numpy(p0.copy()).requires_grad_()
    opt = adam([p], 1e-2)
    tx = optax.adam(1e-2)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj), rtol=0,
                               atol=1e-6)
