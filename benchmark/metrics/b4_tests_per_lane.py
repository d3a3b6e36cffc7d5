"""Triangles B4 (``csrc/intersect_big.cu``) tested a lane over the traced
renders: the launches' ``tests`` counter (the kernel's own count,
``srt_tpu_torch/trace.py``, by ``benchmark.program_spans``) over the
lanes those launches took, dead lanes included. The walk's cost a lane
in its largest part; a better tree or a walk that skips dead lanes
lowers it. Moves ``scan_rays_per_s``."""

from benchmark import program_spans


def read(ctx):
    win = program_spans.window(ctx)
    if win is None:
        return None
    b4 = [r["attrs"] for r in win.calls(("render", "train_step"))
          if r["name"] == "B4" and "tests" in r["attrs"]]
    lanes = sum(a["lanes"] for a in b4)
    return sum(a["tests"] for a in b4) / lanes if lanes else None
