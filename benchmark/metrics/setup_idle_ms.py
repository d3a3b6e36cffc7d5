"""The card's idle time per traced item in the holes that opened while
the host set the call up, in ms: holes whose innermost program span
(``srt_tpu_torch/trace.py``, by ``benchmark.program_spans``) is no read
and is ``setup`` (the flags, the route, ``RegenInputs``, the film's
scratch), ``rays`` (the scan engine's camera rays of a chunk) or lies
under one of them. The reader of every ``setup_idle_ms.<x>``:
``.render``, the regeneration engine's renders, moves
``render_rays_per_s``; ``.scan``, the scan engine's, with every chunk's
``rays``, moves ``scan_rays_per_s``."""
from benchmark import program_spans

SETUP = ("setup", "rays")


def read(ctx):
    win = program_spans.window(ctx)
    if win is None:
        return None
    return win.idle_ms(lambda chain: not chain[0]["read"] and any(
        r["name"] in SETUP for r in chain))
