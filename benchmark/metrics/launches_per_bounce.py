"""Device kernel launches a bounce of a render's host loop: the profiler's
kernel count over the traced renders, over their bounces
(``RenderMetrics.bounces``; the scan engine counts each chunk's lockstep
bounces). The reader of every ``launches_per_bounce.<x>``: ``.render``,
the regeneration engine's ``render/regen.py:_regen_loop``, moves
``render_rays_per_s``; ``.scan``, ``render/api.py:sample_chunks`` and
``render/integrator.py:trace``, moves ``scan_rays_per_s``. Each launch
costs the host its issue time."""


def read(ctx):
    if ctx.get("kind") != "render":
        return None
    bounces = sum(m.bounces for m in ctx["metrics"])
    launches = len(ctx["trace"].kernels())
    return launches / bounces if bounces and launches else None
