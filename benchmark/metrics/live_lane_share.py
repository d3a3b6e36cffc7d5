"""The share of the lanes a bounce kernel sweeps that are live, over the
traced items, in %, from the program's counters
(``srt_tpu_torch/trace.py``, by ``benchmark.program_spans``). The reader
of every ``live_lane_share.<x>``: ``.render``, 100 × the regeneration
renders' ``path_vertices`` (the film's count of live lanes) over the
lanes of their B1 launches, moves ``render_rays_per_s``; ``.scan``, 100
× the B2 launches' ``live`` (counted by the kernel) over their
``lanes``, moves ``scan_rays_per_s``; ``.train``, the same over the
steps' forward B2 launches (B5 sweeps the same lanes), moves
``train_step_ms``."""
from benchmark import program_spans


def read(ctx):
    win = program_spans.window(ctx)
    if win is None:
        return None
    regen = win.calls(("render_regen",))
    if regen:
        lanes = sum(r["attrs"]["lanes"] for r in regen if r["name"] == "B1")
        live = sum(r["attrs"].get("path_vertices", 0) for r in regen
                   if r["parent"] is None)
    else:
        b2 = [r["attrs"] for r in win.calls(("render", "train_step"))
              if r["name"] == "B2" and "live" in r["attrs"]]
        lanes = sum(a["lanes"] for a in b2)
        live = sum(a["live"] for a in b2)
    return 100.0 * live / lanes if lanes else None
