"""B2 (``csrc/bounce.cu``) against its roofline over the traced renders of
the scan engine, in %: the least time its live lanes need
(``benchmark.work.b2``; path vertices from the renders' counters) over
B2's device time in the profiler. Moves ``scan_rays_per_s``."""

from benchmark import work

KERNEL = r"(^|[^A-Za-z0-9_])bounce_kernel"


def read(ctx):
    if ctx.get("kind") != "render":
        return None
    seconds, launches = ctx["trace"].kernel_seconds(KERNEL)
    if not launches or seconds <= 0.0:
        return None
    least = sum(work.b2(ctx["arrays"], vertices=m.path_vertices,
                        rays=m.primary_rays)[0] for m in ctx["metrics"])
    return 100.0 * least / seconds
