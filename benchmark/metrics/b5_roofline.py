"""B5 (``csrc/bounce_bwd.cu``) against its roofline over the traced train
steps, in %: the least time the backward of their live lanes needs
(``benchmark.work.b5``; live lanes counted by the plain reference on the
steps' own rays) over B5's device time in the profiler. Moves
``train_step_ms``."""

from benchmark import work

KERNEL = r"bounce_bwd_kernel"


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    seconds, launches = ctx["trace"].kernel_seconds(KERNEL)
    if not launches or seconds <= 0.0:
        return None
    least = sum(work.b5(ctx["arrays"], vertices=v, rays=ctx["rays"])[0]
                for v in ctx["vertices"])
    return 100.0 * least / seconds
