"""Small copies of the benchmark's cells for the CPU tests: the cell's
configuration, metrics and limits, its traffic at a few pixels."""
from __future__ import annotations

from benchmark import spec

SMALL_RENDER = dict(width=12, height=12, spp=4, wavefront=256, warmup_spp=2,
                    trace_items=1, check_pixels=144, pixel_chunk=64,
                    sample_chunk=2)
SMALL_TRAIN = dict(width=8, height=8, spp=2, trace_items=1)


def small_cell(name: str) -> spec.Cell:
    real = spec.Cell(name)
    t = dict(real.traffic)
    t.update(SMALL_TRAIN if t["entry"] == "train_step" else SMALL_RENDER)
    return spec.Cell.from_parts(name, real.entry, real.config, t,
                                real.limits, real.end_to_end, real.per_layer)
