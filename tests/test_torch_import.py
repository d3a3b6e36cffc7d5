"""srt_tpu_torch stands alone: importing it (the command line, its
``__main__``, the checkpoint and cache utilities, the distribution and
MERL modules, the mesh loaders and the tools among its modules),
rendering ball_scenes, cornell_boxes and teapot_scene (its native BVH
builder, clusters, the two-level walk, specular materials and a medium)
with either engine, running the command line into a PNG and taking a
train step on the CPU pull in neither JAX nor the JAX package, nor
anything the GPU machine lacks. No module of the port imports ``triton``: PyTorch itself
may (on a machine that has it, its optimisers reach ``torch._dynamo``),
so the script records the frame that first imports it."""
from __future__ import annotations

import json
import os
import subprocess
import sys

_SCRIPT = """
import importlib.abc, json, sys, traceback, warnings
warnings.simplefilter("ignore")


class TritonWatch(importlib.abc.MetaPathFinder):
    \"\"\"Records the stack (file:line, importer last) of triton's first
    import; a lookup that does not import it records nothing.\"\"\"
    stack = None

    def find_spec(self, name, path, target=None):
        if name != "triton":
            return None
        for finder in sys.meta_path:
            spec = (finder.find_spec(name, path, target)
                    if finder is not self and hasattr(finder, "find_spec")
                    else None)
            if spec is not None:
                break
        else:
            return None
        real = spec.loader

        class Loader(importlib.abc.Loader):
            def create_module(self, spec):
                return real.create_module(spec)

            def exec_module(self, module):
                if TritonWatch.stack is None:
                    TritonWatch.stack = [
                        f"{f.filename}:{f.lineno}"
                        for f in traceback.extract_stack()[:-1]
                        if not f.filename.startswith("<frozen")
                        and "/importlib/" not in f.filename]
                real.exec_module(module)
        spec.loader = Loader()
        return spec


sys.meta_path.insert(0, TritonWatch())
import torch
import srt_tpu_torch
from srt_tpu_torch import (RenderConfig, get_scene, make_train_step,
                           render_regen)
import srt_tpu_torch.kernels.build, srt_tpu_torch.convert
import srt_tpu_torch.diff, srt_tpu_torch.render.regen_scan
import srt_tpu_torch.trainbench
import srt_tpu_torch.cli, srt_tpu_torch.__main__
import srt_tpu_torch.utils.checkpoint, srt_tpu_torch.utils.cache
import srt_tpu_torch.dist.multihost, srt_tpu_torch.io.merl
import srt_tpu_torch.materials.merl, srt_tpu_torch.io.mesh
import srt_tpu_torch.phases, srt_tpu_torch.golden_avg, srt_tpu_torch.regions
import srt_tpu_torch.dist.scaling
from srt_tpu_torch.dist import make_mesh, render_sharded
import os, tempfile
scene, cam, _ = get_scene("ball_scenes", device="cpu")
img = render_regen(scene, cam, RenderConfig(width=8, height=8, spp=1,
                                            max_depth=3))
tri_scene, tri_cam, _ = get_scene("cornell_boxes", device="cpu")
tri_img = render_regen(tri_scene, tri_cam,
                       RenderConfig(width=8, height=8, spp=2, max_depth=4))
import srt_tpu_torch.kernels.intersect, srt_tpu_torch.accel.bvh
from srt_tpu_torch.render import intersect as ri
ri.SINGLE_LEVEL_BUDGET = 0          # the two-level walk on a small mesh
pot, pot_cam, _ = get_scene("teapot_scene", device="cpu", divs=3)
pot_img = render_regen(pot, pot_cam,
                       RenderConfig(width=8, height=8, spp=2, max_depth=4))
step = make_train_step(scene, cam, {"tex_color": scene.tex_color}, width=4,
                       height=4, spp=1, max_depth=2, device="cpu")
loss = step(torch.full((4, 4, 3), 0.3), 0)
scan_img = srt_tpu_torch.render(tri_scene, tri_cam, RenderConfig(
    width=8, height=8, spp=2, max_depth=4))
sharded = render_sharded(tri_scene, tri_cam, RenderConfig(
    width=8, height=8, spp=2, max_depth=4), make_mesh(device="cpu"))
jade, _, _ = get_scene("jadebunny_scene", device="cpu")
f_merl = srt_tpu_torch.materials.merl.lookup(
    torch.ones((1, 3, 8)), torch.zeros(1), torch.tensor([[0.0, 0.0, 1.0]]),
    torch.tensor([[0.0, 0.0, 1.0]]))
png = os.path.join(tempfile.mkdtemp(), "out.png")
cli_rc = srt_tpu_torch.cli.main(["--scene", "balls", "--width", "8", "--spp",
                                 "1", "--max-depth", "2", "--device", "cpu",
                                 "--no-compile-cache", "--out", png])
print(json.dumps({"shape": list(img.shape),
                  "finite": bool(img.isfinite().all()
                                 and tri_img.isfinite().all()
                                 and tri_img.mean() > 0
                                 and pot_img.isfinite().all()
                                 and pot_img.mean() > 0
                                 and loss.isfinite()
                                 and scan_img.isfinite().all()
                                 and scan_img.mean() > 0
                                 and torch.equal(sharded, scan_img)
                                 and jade.rect_k.shape[0] > 0
                                 and bool((f_merl == 1).all())
                                 and cli_rc == 0 and os.path.isfile(png)),
                  "modules": sorted(m.split(".")[0] for m in sys.modules),
                  "triton_importer": TritonWatch.stack}))
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["shape"] == [8, 8, 3] and res["finite"]
    for banned in ("jax", "jaxlib", "srt_tpu", "PIL"):
        assert banned not in res["modules"], banned
    # triton only where PyTorch imports it: the frame that first imported
    # it lies outside the port and chip_smoke.py
    stack = res["triton_importer"]
    assert ("triton" in res["modules"]) == bool(stack), stack
    if stack:
        importer = os.path.realpath(stack[-1].rsplit(":", 1)[0])
        real = os.path.realpath(root)
        port = (os.path.join(real, "srt_tpu_torch") + os.sep,
                os.path.join(real, "chip_smoke.py"))
        assert not importer.startswith(port), stack


def test_chip_smoke_holds_the_outputs_of_every_timed_launch():
    """``chip_smoke.py`` times kernels by launching on arguments built
    once. The outputs those arguments point at must stay alive while it
    launches: an output dropped as ``_`` goes back to the caching
    allocator, and the timed launches would write into whatever tensor
    takes its memory next."""
    import ast
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    dropped = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and isinstance(node.targets[0], ast.Tuple)):
            fn = node.value.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            held = node.targets[0].elts[1:]
            if name.endswith("args") and any(
                    isinstance(e, ast.Name) and e.id == "_" for e in held):
                dropped.append(node.lineno)
    assert not dropped, f"outputs dropped at chip_smoke.py lines {dropped}"
