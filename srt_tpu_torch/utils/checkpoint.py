"""Checkpoint and resume: renders and train steps (counterpart of
``srt_tpu/utils/checkpoint.py``).

A long render saves its radiance *sums* and the samples done; resuming
continues the sample loop. Every random decision is a pure function of
``(seed, pixel, sample, bounce)``, and the sums are made in a fixed order,
so a resumed render equals an uninterrupted :func:`render.api.render` to
the bit. The files are the JAX package's: the same npz keys (``acc``,
``spp_done``, ``config_json``) and the same fingerprint, so either package
resumes the other's checkpoint.

A train step's parameters and Adam state go through the same npz
container as flattened leaves (``n``, ``leaf_0`` ...), as the JAX
package's ``save_pytree`` writes them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from srt_tpu_torch.render.api import render_setup, sample_chunks
from srt_tpu_torch.utils.metrics import RenderMetrics

#: the config fields a checkpoint must share with the render that resumes
#: it (the chunk sizes are execution details)
FINGERPRINT = ("width", "height", "spp", "max_depth", "seed", "rr_start",
               "sobol_pixel_jitter", "pdf_floor")


def _atomic_savez(path: str, **arrays) -> None:
    """Write to a temporary file, then rename, so a crash mid-save never
    leaves a torn checkpoint."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_render_ckpt(path: str, acc, spp_done: int, config) -> None:
    """Persist the radiance sums (pixels, 3), the samples done and the
    config as JSON."""
    meta = json.dumps(dataclasses.asdict(config))
    acc = acc.cpu().numpy() if isinstance(acc, torch.Tensor) else acc
    _atomic_savez(path, acc=np.asarray(acc, np.float32),
                  spp_done=np.int64(spp_done),
                  config_json=np.frombuffer(meta.encode(), np.uint8))


def load_render_ckpt(path: str, config) -> tuple[np.ndarray, int] | None:
    """``(acc, spp_done)``, or None if the file is absent or its config
    differs from ``config`` in a :data:`FINGERPRINT` field."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["config_json"]).decode())
        current = dataclasses.asdict(config)
        if any(meta.get(k) != current.get(k) for k in FINGERPRINT):
            return None
        return z["acc"].copy(), int(z["spp_done"])


def render_resumable(scene, camera, config, ckpt_path: str,
                     ckpt_every_spp: int = 16, metrics: bool = False):
    """Render with the scan engine, saving a checkpoint every
    ``ckpt_every_spp`` samples and resuming from ``ckpt_path`` if it holds
    one for this config; returns the (H, W, 3) linear image on the scene's
    device and deletes the checkpoint when done (``checkpoint.py:67-120``).
    Equal to :func:`render.api.render` with the same config to the bit
    when ``ckpt_every_spp`` is a multiple of ``sample_chunk``: both add
    the same sample chunks (:func:`render.api.sample_chunks`) in the same
    order.
    ``metrics=True`` also returns a :class:`RenderMetrics` of the samples
    this call rendered (route and wall)."""
    _, jitter, route = render_setup(scene, config)
    w, h, spp = config.width, config.height, config.spp
    loaded = load_render_ckpt(ckpt_path, config)
    if loaded is not None:
        acc, s_done = torch.from_numpy(loaded[0]).to(scene.device), loaded[1]
    else:
        acc, s_done = torch.zeros((w * h, 3), dtype=torch.float32,
                                  device=scene.device), 0
    s_ckpt = s_done
    t0 = time.time()
    with torch.no_grad():
        for s0, part, _ in sample_chunks(route, camera, config, jitter,
                                         s_done):
            acc = acc + part
            if s0 - s_ckpt >= ckpt_every_spp and s0 < spp:
                save_render_ckpt(ckpt_path, acc, s0, config)
                s_ckpt = s0
    if os.path.exists(ckpt_path):
        os.unlink(ckpt_path)
    img = (acc / spp).reshape(h, w, 3)
    if not metrics:
        return img
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    return img, RenderMetrics(
        width=w, height=h, spp=spp, max_depth=config.max_depth,
        primary_rays=w * h * (spp - s_done), bounces=route.steps,
        wall_s=time.time() - t0, bounce=route.bounce, walk=route.walk)


# --- train state ----------------------------------------------------------

def _leaves(tree) -> list:
    """The leaves of nested dicts (keys sorted, as ``jax.tree_util``
    orders them), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with the leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def save_pytree(path: str, tree) -> None:
    """Persist nested dicts, lists and tuples of tensors or arrays as npz
    leaves (``n``, ``leaf_0`` ...), the JAX package's container."""
    leaves = _leaves(tree)
    _atomic_savez(path, n=np.int64(len(leaves)), **{
        f"leaf_{i}": (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x)) for i, x in enumerate(leaves)})


def load_pytree(path: str, like):
    """Restore what :func:`save_pytree` wrote into the structure of
    ``like``, as CPU tensors; None if the file is absent or holds another
    number of leaves."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        n = int(z["n"])
        leaves = [torch.from_numpy(z[f"leaf_{i}"].copy()) for i in range(n)]
    if n != len(_leaves(like)):
        return None
    return _unflatten(like, iter(leaves))


def train_state(step) -> tuple[dict, dict]:
    """A train step's ``(params, adam)``: its parameters by name, and for
    each the Adam moments and step count (zeros before the first step)."""
    params = {k: v.detach() for k, v in step.params.items()}
    adam = {}
    for k, p in step.params.items():
        st = step.optimizer.state.get(p, {})
        adam[k] = {"step": torch.as_tensor(st.get("step", 0.0),
                                           dtype=torch.float32),
                   "exp_avg": st.get("exp_avg", torch.zeros_like(p)),
                   "exp_avg_sq": st.get("exp_avg_sq", torch.zeros_like(p))}
    return params, adam


def save_train_state(path: str, step) -> None:
    """Save a :class:`diff.inverse.TrainStep`'s parameters and Adam state
    (:func:`train_state`) through :func:`save_pytree`."""
    save_pytree(path, train_state(step))


def load_train_state(path: str, step) -> bool:
    """Restore what :func:`save_train_state` wrote into ``step`` in place
    (its parameters, and the Adam state of each); False if ``path`` holds
    no state of this shape."""
    loaded = load_pytree(path, train_state(step))
    if loaded is None:
        return False
    params, adam = loaded
    with torch.no_grad():
        for k, p in step.params.items():
            p.copy_(params[k])
            a = adam[k]
            if float(a["step"]) == 0.0:
                step.optimizer.state.pop(p, None)
                continue
            step.optimizer.state[p] = {
                "step": a["step"].clone(),
                "exp_avg": a["exp_avg"].to(p.device).clone(),
                "exp_avg_sq": a["exp_avg_sq"].to(p.device).clone()}
    return True
