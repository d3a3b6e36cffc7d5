"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (``srt_tpu_torch`` begins with ``srt_tpu``); the
plain reference imports nothing of the program."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark import run, spec


def modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    mods = modules_after(
        "import benchmark.run, benchmark.drivers, benchmark.check, "
        "benchmark.trace, benchmark.work, benchmark.faults\n"
        "import benchmark.tools.readings\n"
        "from benchmark import spec\n"
        "for m in spec.benchmark()['per_layer']: spec.reader(m['name'])\n"
        "spec.Cell('ball_render').scene()\n"
        "spec.Cell('random_render').scene()")
    assert "srt_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "srt_tpu"}


def test_reference_imports_nothing_of_the_program():
    mods = modules_after(
        "import benchmark.reference.path, benchmark.reference.camera, "
        "benchmark.reference.scene, benchmark.reference.triangles, "
        "benchmark.reference.media, benchmark.scenes.builder, "
        "benchmark.scenes.ball_scenes, benchmark.scenes.random_scene, "
        "benchmark.check, benchmark.work")
    assert not mods & {"srt_tpu_torch", "srt_tpu", "jax", "jaxlib"}


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "srt_tpu_torch_x", sys)
    assert "srt_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "srt_tpu.core", sys)
    assert run.forbidden_modules() == ["srt_tpu"]
