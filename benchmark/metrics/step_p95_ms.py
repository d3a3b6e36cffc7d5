"""The 95th percentile of the window's train step walls, in ms (host
clock): a step's wall runs from the previous step call's return to its
own. Layer: ``diff/inverse.py:make_train_step``. Reported beside
``train_step_ms``, which it moves; kept off the end-to-end metrics since
its runs spread more widely than any bound allows (``PERF.md`` §2)."""
import numpy as np


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("step_walls"):
        return None
    return 1e3 * float(np.percentile(ctx["step_walls"], 95))
