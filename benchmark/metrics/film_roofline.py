"""The film (``csrc/film_sum.cu``) against its roofline over the traced
renders, in %: the least time their sums need (``benchmark.work.film``)
over the film kernel's device time in the profiler. Moves
``render_rays_per_s``."""

from benchmark import work

KERNEL = r"film_sum_kernel"


def read(ctx):
    if ctx.get("kind") != "render":
        return None
    seconds, launches = ctx["trace"].kernel_seconds(KERNEL)
    if not launches or seconds <= 0.0:
        return None
    least = sum(work.film(launches=m.bounces, lanes=ctx["lanes"],
                          rays=m.primary_rays, pixels=ctx["pixels"])[0]
                for m in ctx["metrics"])
    return 100.0 * least / seconds
