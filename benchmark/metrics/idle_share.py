"""The card's idle share of a render or a train step, in %: one less
device busy per item (the union of the profiler's device operations over
the traced items) over the wall per item measured with the profiler off
(the window of the same process). The reader of every ``idle_share.<x>``:
``.render`` (the regeneration engine's renders) moves
``render_rays_per_s``, ``.scan`` (the scan engine's) ``scan_rays_per_s``,
``.train`` (train steps) ``train_step_ms``."""


def read(ctx):
    if ctx.get("kind") not in ("render", "train"):
        return None
    busy = ctx["trace"].busy_s / ctx["items"]
    if busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / ctx["wall_per_item"])
