"""The device time of a train step's backward, the mean over the traced
steps, in ms: the ``backward`` span's ``device_ms``, from a pair of CUDA
events the program records on the step's stream around
``loss.backward()`` (``diff/inverse.py:TrainStep``,
``srt_tpu_torch/trace.py``), with no synchronise. Layer: the train step
(B5 and the material sum, ``kernels/bounce_vjp.py``). Moves
``train_step_ms``."""
from benchmark import program_spans


def read(ctx):
    win = program_spans.window(ctx)
    if win is None:
        return None
    ms = [r["attrs"]["device_ms"] for r in win.calls(("train_step",))
          if r["name"] == "backward"
          and r["attrs"].get("device_ms") is not None]
    return sum(ms) / len(ms) if ms else None
