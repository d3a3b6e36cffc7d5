"""B4 (``csrc/intersect_big.cu``, the two-level triangle walk) against
its roofline over the traced renders, in %: the least time the walks of
their live lanes need (``benchmark.work_tris.b4``) over the device time
of B4's kernels in the profiler. A live lane is one B2 shades on the
bounce whose hits the B4 launch just before it found: B2's ``live``
counter on that launch (``srt_tpu_torch/trace.py``, by
``benchmark.program_spans``). Moves ``scan_rays_per_s``."""

from benchmark import program_spans, work_tris

KERNEL = r"intersect_big_kernel"


def walked(win) -> tuple[int, int]:
    """The window's B4 launches, and the live lanes of the B2 launch that
    follows each within its call and parent span."""
    launches = lanes = 0
    last_b4 = None
    for r in win.calls(("render", "train_step")):
        if r["name"] == "B4":
            launches += 1
            last_b4 = (r["call"], r["parent"])
        elif r["name"] == "B2":
            if last_b4 == (r["call"], r["parent"]) and "live" in r["attrs"]:
                lanes += r["attrs"]["live"]
            last_b4 = None
    return launches, lanes


def read(ctx):
    if ctx.get("kind") != "render":
        return None
    seconds, kernels = ctx["trace"].kernel_seconds(KERNEL)
    if not kernels or seconds <= 0.0:
        return None
    win = program_spans.window(ctx)
    if win is None:
        return None
    launches, lanes = walked(win)
    if not launches or not lanes:
        return None
    return 100.0 * work_tris.b4(lanes=lanes, launches=launches)[0] / seconds
