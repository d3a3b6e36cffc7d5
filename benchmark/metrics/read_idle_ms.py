"""The card's idle time per traced item in the holes that opened while
the host waited for the card in a read of the program, in ms: holes
whose innermost program span (``srt_tpu_torch/trace.py``, by
``benchmark.program_spans``) is marked ``read``, that is ``tables`` (the
lights' rows, ``kernels/bounce.py:build_tables``) and ``check`` (the
regeneration loop's cursor and any-alive read every eight bounces). The
reader of every ``read_idle_ms.<x>``: ``.render``, the regeneration
engine's renders, moves ``render_rays_per_s``; ``.train``, the train
steps (``tables``), moves ``train_step_ms``."""
from benchmark import program_spans


def read(ctx):
    win = program_spans.window(ctx)
    if win is None:
        return None
    return win.idle_ms(lambda chain: chain[0]["read"])
