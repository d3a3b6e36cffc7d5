"""The train step on the rich families: its gradient against central
differences of its own loss, the hybrid on ``random_scene``, and the
gates that send each scene to its backward.

On the CPU every bounce is the plain step under autograd, which kernel
B5's rich instantiation (``csrc/bounce_bwd.cu``, ``kRich``) is held
against on the card (``chip_smoke.py`` phases 19-20). ``random_scene``'s
spheres move, so its backward is the hybrid, as JAX's gate sends it;
JAX's gradient there detaches the BSDF sample (ROADMAP C12), so only finite
differences hold it.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch
from _torch_scenes import LIT_ROOM_CAMERA, lit_room_media

from srt_tpu_torch import get_scene, make_train_step
from srt_tpu_torch.diff.inverse import image_loss
from srt_tpu_torch.kernels import launch_counts
from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import bounce_bwd as kbb
from srt_tpu_torch.kernels import bounce_vjp as kv
from srt_tpu_torch.render.camera import Camera
from srt_tpu_torch.scene.build import SceneBuilder
from srt_tpu_torch.scene.ir import (MaterialType, SceneFlags, TorchScene,
                                    require_covered, require_trainable,
                                    rich_families)

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:asset .* missing")

LOSS = dict(width=16, height=16, spp=2, max_depth=4)
# per scene, the parameters whose gradient is checked: the checker's two
# colours, the marble's and the earth's scene colours (the dome, the
# ground), the media room's colours and material parameters
FD_PARAMS = {"two_spheres": ("tex_color", "tex_color2"),
             "two_perlin_spheres": ("tex_color",),
             "earth_sphere": ("tex_color",),
             "lit_room_media": ("tex_color", "mat_params")}


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _scene(name: str):
    if name == "lit_room_media":
        return (lit_room_media(SceneBuilder()).build("cpu"),
                Camera.look_at(**LIT_ROOM_CAMERA, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene(name, device="cpu")
    return scene, cam


def _entries(key, grad):
    """The entries of parameter ``key`` to difference: the two with the
    largest gradient, the one for the material parameters (they move the
    sampled directions; the media room's metal and glass spheres fill too
    few pixels at this size for their own parameters to be held here, and
    ``tests/test_torch_train_rich.py`` holds their cotangents against
    JAX's)."""
    flat = np.argsort(np.abs(grad).ravel())[-(1 if key == "mat_params"
                                              else 2):]
    return [tuple(int(i) for i in np.unravel_index(f, grad.shape))
            for f in flat]


@pytest.mark.parametrize("name", list(FD_PARAMS))
def test_rich_gradients_match_finite_differences(name, flush_denormals):
    """The train step's gradient on each rich scene (16x16, 2 spp, depth
    4, a constant 0.3 target) against central differences of its own loss
    with common random numbers, on the largest entries of each parameter:
    within 3e-3 plus 5% of the difference quotient, the bound of
    ``test_torch_train.py``. The bounce's backward here is B5's plain
    version (``kernels.bounce_vjp.BounceCore``)."""
    scene, cam = _scene(name)
    assert kbb.bwd_kernel_available(scene, SceneFlags.of(scene))
    pix = torch.arange(LOSS["width"] * LOSS["height"])
    target = torch.full((pix.shape[0], 3), 0.3)
    keys = FD_PARAMS[name]

    def loss(params):
        return image_loss(params, scene, cam, target, pix, seed=7, **LOSS)

    params = {k: getattr(scene, k).clone().requires_grad_() for k in keys}
    loss(params).backward()
    checked = 0
    for k in keys:
        g = params[k].grad.numpy()
        assert np.isfinite(g).all(), k
        eps = 1e-3 if k == "mat_params" else 3e-3
        for idx in _entries(k, g):
            delta = torch.zeros_like(params[k])
            delta[idx] = eps
            base = {j: getattr(scene, j) for j in keys}
            with torch.no_grad():
                q = (float(loss(dict(base, **{k: base[k] + delta})))
                     - float(loss(dict(base, **{k: base[k] - delta})))) \
                    / (2 * eps)
            assert abs(g[idx]) > 1e-4, (k, idx, g[idx])
            assert abs(q - g[idx]) < 3e-3 + 0.05 * abs(q), (k, idx, q, g[idx])
            checked += 1
    assert checked == 2 * len([k for k in keys if k != "mat_params"]) \
        + ("mat_params" in keys)


def test_hybrid_on_random_scene_matches_finite_differences(flush_denormals):
    """random_scene (moving spheres, checker ground, metal and glass,
    image-textured rect lights) takes the hybrid backward; its
    ``tex_color`` gradient at 16x16, 2 spp, depth 4 against central
    differences of its own loss, the two largest entries, the same
    bound."""
    scene, cam = _scene("random_scene")
    flags = SceneFlags.of(scene)
    assert flags.moving and not kbb.bwd_kernel_available(scene, flags)
    pix = torch.arange(LOSS["width"] * LOSS["height"])
    target = torch.full((pix.shape[0], 3), 0.3)

    def loss(tc):
        return image_loss({"tex_color": tc}, scene, cam, target, pix, seed=3,
                          **LOSS)
    tc = scene.tex_color.clone().requires_grad_()
    loss(tc).backward()
    g = tc.grad.numpy()
    assert np.isfinite(g).all()
    for idx in _entries("tex_color", g):
        delta = torch.zeros_like(tc)
        delta[idx] = 3e-3
        with torch.no_grad():
            q = (float(loss(scene.tex_color + delta))
                 - float(loss(scene.tex_color - delta))) / 6e-3
        assert abs(g[idx]) > 1e-4, (idx, g[idx])
        assert abs(q - g[idx]) < 3e-3 + 0.05 * abs(q), (idx, q, g[idx])


@pytest.mark.parametrize("name", ["two_spheres", "two_perlin_spheres",
                                  "earth_sphere", "lit_room_media",
                                  "random_scene", "final"])
def test_train_gate_takes_every_rendered_family(name):
    """``require_trainable`` admits each scene the render side covers,
    and the backward kernel's gate (JAX's, less parity) keeps only
    triangles and moving spheres for the hybrid; the train step's bounce
    takes B5 exactly when that gate admits the scene."""
    scene, _ = _scene(name)
    flags = SceneFlags.of(scene)
    assert rich_families(scene, flags)
    require_covered(scene, flags)
    require_trainable(scene, flags)
    b5 = kbb.bwd_kernel_available(scene, flags)
    assert b5 == (not scene.n_tris and not flags.moving)
    if b5:
        kbb.require_bwd_kernel(scene, flags)
    else:
        with pytest.raises(NotImplementedError, match="hybrid backward"):
            kbb.require_bwd_kernel(scene, flags)


def _mesh_medium(scene: TorchScene) -> TorchScene:
    return dataclasses.replace(
        scene, med_kind=torch.full((1,), 2, dtype=torch.int32),
        med_center=torch.zeros((1, 3)), med_radius=torch.ones(1),
        med_half=torch.ones((1, 3)), med_density=torch.ones(1),
        med_mat=torch.zeros(1, dtype=torch.int32))


def _merl(scene: TorchScene) -> TorchScene:
    mt = scene.mat_type.clone()
    mt[-1] = int(MaterialType.MERL)
    return dataclasses.replace(scene, mat_type=mt,
                               merl=torch.zeros((1, 3, 1)))


@pytest.mark.parametrize("case,item", [("mesh_medium", "A7"),
                                       ("merl", "A12"), ("parity", "A13")])
def test_train_gate_still_refuses(case, item):
    """What the train step refused, by the ROADMAP item that covered it:
    MERL (A12) and mesh-bounded media (A7) train through the plain bounce
    under autograd, the route the bounce kernels' gate gives them, on a
    rich scene as on any other. The parity estimator renders, and the
    backward kernel refuses it, as JAX's gate does (its bounce takes the
    hybrid backward); the train step never sets it."""
    scene, cam = _scene("two_spheres")
    if case == "parity":
        flags = SceneFlags.of(scene)._replace(ref_parity=True)
        require_covered(scene, flags)
        assert not kbb.bwd_kernel_available(scene, flags)
        with pytest.raises(NotImplementedError, match="parity"):
            kbb.require_bwd_kernel(scene, flags)
        return
    if case in ("mesh_medium", "merl"):
        media = _mesh_medium(scene) if case == "mesh_medium" else _merl(scene)
        require_trainable(media, SceneFlags.of(media))
        step = make_train_step(media, cam, {"tex_color": media.tex_color},
                               width=4, height=4, spp=1, max_depth=2,
                               device="cpu")
        assert torch.isfinite(step(torch.full((4, 4, 3), 0.3), 0))
        assert not SceneFlags.of(media).fused_bounce


def test_coverage_gate_reads_no_device_memory():
    """The mesh-medium fact is read once, into ``SceneFlags``: the gate
    the train step runs before every backward launch reads the flags and
    the tables' shapes only, so it holds with the media table on the meta
    device (whose values cannot be read), and it admits a mesh-bounded
    medium, which the flags send to the plain bounce."""
    scene, _ = _scene("lit_room_media")
    flags = SceneFlags.of(scene)
    assert not flags.mesh_media
    meta = dataclasses.replace(scene, med_kind=scene.med_kind.to("meta"))
    require_covered(meta, flags)
    require_trainable(meta, flags)
    kbb.require_bwd_kernel(meta, flags)
    mesh = _mesh_medium(scene)
    mflags = SceneFlags.of(mesh)
    assert mflags.mesh_media and not mflags.fused_bounce
    require_covered(dataclasses.replace(
        mesh, med_kind=mesh.med_kind.to("meta")), mflags)


@pytest.mark.parametrize("name,perlin", [
    ("two_spheres", 0), ("two_perlin_spheres", 1), ("earth_sphere", 0),
    ("lit_room_media", 0)])
def test_bwd_arguments_pick_the_rich_instantiation(name, perlin):
    """B5's launch arguments, built on the CPU from the flags: the rich
    instantiation on each rich scene, its media and lights' kinds set, the
    Perlin tables staged only for a noise texture; ball_scenes stays
    lean."""
    for scene_name in (name, "ball_scenes"):
        scene, cam = _scene(scene_name)
        flags = SceneFlags.of(scene)
        tables = kb.build_tables(scene, flags)
        n = 8
        st = dict(o=torch.zeros((n, 3)), d=torch.ones((n, 3)),
                  beta=torch.ones((n, 3)), radiance=torch.zeros((n, 3)),
                  time=torch.zeros(n), salt=torch.zeros(n, dtype=torch.int32),
                  depth=torch.zeros(n, dtype=torch.int32),
                  alive=torch.ones(n, dtype=torch.bool))
        ct = {k: torch.ones((n, 3)) for k in kbb.ROWS}
        args, _ = kbb.bwd_args(scene, flags, tables, st, ct,
                               kb.StepSpec(max_depth=8))
        rich = scene_name != "ball_scenes"
        assert args.rich == int(rich)
        assert args.perlin == (perlin if rich else 0)
        assert args.n_med == (scene.n_media if rich else 0)
        assert bool(args.light_kind) == rich


def test_rich_train_step_runs_on_the_plain_bounce():
    """``make_train_step`` on a rich scene on the CPU: the bounce is
    ``BounceCore`` (B2 and B5, their plain versions here), no launch, and
    the loss and the colours' gradient are finite."""
    scene, cam = _scene("two_perlin_spheres")
    took = []
    core = kv.bounce_core

    def spy(*a):
        took.append("B5")
        return core(*a)
    kv.bounce_core, before = spy, launch_counts()["B5"]
    try:
        step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                               width=4, height=4, spp=1, max_depth=3,
                               device="cpu")
        loss = float(step(torch.full((4, 4, 3), 0.3), 0))
    finally:
        kv.bounce_core = core
    assert took and set(took) == {"B5"} and launch_counts()["B5"] == before
    assert np.isfinite(loss)
    assert torch.isfinite(step.params["tex_color"].grad).all()
