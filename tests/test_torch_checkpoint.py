"""Checkpoint and resume in the port (mirrors of ``tests/test_checkpoint.py``)
and across the packages: a resumed render equals the uninterrupted
``render`` to the bit, a render stopped after its first checkpoint resumes
to the same bits, a mismatched checkpoint is refused, a train step's
parameters and Adam state round-trip, and the two packages read each
other's render checkpoints (the same npz keys and fingerprint)."""
from __future__ import annotations

import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import scenes

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu.core.sobol import sobol_points as jax_sobol_points
from srt_tpu.render.api import _render_chunk as jax_render_chunk
from srt_tpu.scene.ir import SceneFlags as JaxSceneFlags
from srt_tpu.utils.checkpoint import load_render_ckpt as jax_load_render_ckpt
from srt_tpu.utils.checkpoint import save_render_ckpt as jax_save_render_ckpt
from srt_tpu_torch import RenderConfig, get_scene, make_train_step, render
from srt_tpu_torch.render.api import _render_chunk, render_setup
from srt_tpu_torch.utils import checkpoint as ck
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)

CFG = dict(width=12, height=12, spp=4, max_depth=4, sample_chunk=2)


@pytest.fixture(scope="module")
def boxes():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene("cornell_boxes", device="cpu")
    return scene, cam, render(scene, cam, RenderConfig(**CFG))


def test_resumable_equals_plain(boxes, tmp_path):
    scene, cam, full = boxes
    path = str(tmp_path / "r.npz")
    res = ck.render_resumable(scene, cam, RenderConfig(**CFG), path,
                              ckpt_every_spp=2)
    assert torch.equal(full, res)
    assert not os.path.exists(path)        # deleted on completion


def _partial(scene, cam, cfg) -> torch.Tensor:
    """The sums of samples 0..1 as the resumable loop computes them."""
    _, jitter, route = render_setup(scene, cfg)
    with torch.no_grad():
        return _render_chunk(route, cam, torch.arange(cfg.width * cfg.height),
                             0, jitter, cfg.seed, width=cfg.width,
                             height=cfg.height, n_samples=2)


def test_resume_from_partial_checkpoint(boxes, tmp_path):
    """A crash after 2 of 4 spp: the resumed render is bit-identical."""
    scene, cam, full = boxes
    cfg = RenderConfig(**CFG)
    path = str(tmp_path / "r.npz")
    ck.save_render_ckpt(path, _partial(scene, cam, cfg), 2, cfg)
    assert torch.equal(full, ck.render_resumable(scene, cam, cfg, path))


def test_stopped_render_resumes_to_the_bit(boxes, tmp_path, monkeypatch):
    """A render stopped right after its first checkpoint, then run again:
    the second run resumes from the file and ends at the same bits."""
    scene, cam, full = boxes
    cfg = RenderConfig(**CFG)
    path = str(tmp_path / "r.npz")
    save = ck.save_render_ckpt

    class Stop(Exception):
        pass

    def save_then_stop(*args, **kw):
        save(*args, **kw)
        raise Stop
    monkeypatch.setattr(ck, "save_render_ckpt", save_then_stop)
    with pytest.raises(Stop):
        ck.render_resumable(scene, cam, cfg, path, ckpt_every_spp=2)
    monkeypatch.setattr(ck, "save_render_ckpt", save)
    assert ck.load_render_ckpt(path, cfg)[1] == 2
    img, m = ck.render_resumable(scene, cam, cfg, path, ckpt_every_spp=2,
                                 metrics=True)
    assert torch.equal(full, img)
    assert m.primary_rays == 12 * 12 * 2 and (m.bounce, m.walk) == ("B2",
                                                                    "B3")


def test_mismatched_checkpoint_rejected(tmp_path):
    cfg = RenderConfig(**CFG)
    path = str(tmp_path / "r.npz")
    ck.save_render_ckpt(path, np.ones((144, 3), np.float32), 2, cfg)
    assert ck.load_render_ckpt(path, RenderConfig(**{**CFG, "seed": 99})) \
        is None
    acc, done = ck.load_render_ckpt(path, cfg)
    assert done == 2 and acc.shape == (144, 3)
    # chunk sizes are execution details
    assert ck.load_render_ckpt(path, dataclasses.replace(
        cfg, sample_chunk=4, pixel_chunk=16)) is not None


def test_pytree_roundtrip(tmp_path):
    tree = {"a": torch.arange(3.0), "b": {"c": torch.ones((2, 2))},
            "d": [torch.zeros(2, dtype=torch.int32), np.float32(2.5)]}
    path = str(tmp_path / "t.npz")
    ck.save_pytree(path, tree)
    back = ck.load_pytree(path, tree)
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    assert torch.equal(back["d"][0], tree["d"][0])
    assert float(back["d"][1]) == 2.5
    assert ck.load_pytree(path, {"a": tree["a"]}) is None
    assert ck.load_pytree(str(tmp_path / "absent.npz"), tree) is None


def test_train_state_roundtrip(tmp_path):
    """A train step's parameters and Adam state saved after two steps and
    loaded into a fresh step: the next step of both gives the same loss
    and the same parameters, bit for bit."""
    scene, cam, _ = get_scene("ball_scenes", device="cpu")
    kw = dict(width=4, height=4, spp=1, max_depth=2, device="cpu")
    target = torch.full((4, 4, 3), 0.3)
    a = make_train_step(scene, cam, {"tex_color": scene.tex_color}, **kw)
    for seed in (0, 1):
        a(target, seed)
    path = str(tmp_path / "opt.npz")
    ck.save_train_state(path, a)
    b = make_train_step(scene, cam, {"tex_color": scene.tex_color}, **kw)
    assert ck.load_train_state(path, b)
    assert torch.equal(a.params["tex_color"], b.params["tex_color"])
    assert torch.equal(a(target, 2), b(target, 2))
    assert torch.equal(a.params["tex_color"], b.params["tex_color"])
    assert not ck.load_train_state(str(tmp_path / "absent.npz"), b)


def test_checkpoints_cross_the_packages(tmp_path):
    """JAX's checkpoint of samples 0..1 resumed by the port, within the
    image contract of the port's uninterrupted render (JAX's half of the
    sums rounds its own way); the port's read back by JAX, bit for bit."""
    scene_j, cam_j, scene, cam = scenes("cornell_boxes")
    cfg_j, cfg = JaxRenderConfig(**CFG), RenderConfig(**CFG)
    n = CFG["width"] * CFG["height"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        acc_j = np.asarray(jax_render_chunk(
            scene_j, cam_j, jnp.arange(n, dtype=jnp.int32), 0,
            jnp.asarray(jax_sobol_points(4, 2), jnp.float32), cfg_j.seed,
            width=12, height=12, max_depth=4, rr_start=cfg_j.rr_start,
            n_samples=2, flags=JaxSceneFlags.of(scene_j)))
    path = str(tmp_path / "jax.npz")
    jax_save_render_ckpt(path, acc_j, 2, cfg_j)
    acc, done = ck.load_render_ckpt(path, cfg)
    assert done == 2 and np.array_equal(acc, acc_j)
    resumed = ck.render_resumable(scene, cam, cfg, path)
    contract.check_image(resumed.numpy(), render(scene, cam, cfg).numpy())

    ours = str(tmp_path / "port.npz")
    part = _partial(scene, cam, cfg)
    ck.save_render_ckpt(ours, part, 2, cfg)
    acc_back, done_back = jax_load_render_ckpt(ours, cfg_j)
    assert done_back == 2 and np.array_equal(acc_back, part.numpy())
