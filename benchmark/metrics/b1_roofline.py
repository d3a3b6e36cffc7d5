"""B1 (``csrc/regen_bounce.cu``) against its roofline over the traced
renders, in %: the least time their work needs (``benchmark.work.b1``:
each launch's wavefront, each traced path vertex's sweep and shading)
over B1's device time in the profiler. Moves ``render_rays_per_s``."""

from benchmark import work

KERNEL = r"regen_bounce_kernel"


def read(ctx):
    if ctx.get("kind") != "render":
        return None
    seconds, launches = ctx["trace"].kernel_seconds(KERNEL)
    if not launches or seconds <= 0.0:
        return None
    least = sum(work.b1(ctx["arrays"], launches=m.bounces,
                        lanes=ctx["lanes"], vertices=m.path_vertices,
                        rays=m.primary_rays)[0] for m in ctx["metrics"])
    return 100.0 * least / seconds
