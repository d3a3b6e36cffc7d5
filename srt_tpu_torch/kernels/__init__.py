"""The hand-written CUDA kernels B1-B6, the film sum and the material sum,
and their wrappers. Each wrapper adds one to its kernel's launch counter
in :data:`srt_tpu_torch.trace.COUNTS` where it launches its kernel;
:func:`launch_counts` reads them all and :func:`reset_launch_counts` sets
them to 0."""
from srt_tpu_torch import trace as tracer


def reset_launch_counts() -> None:
    """Every kernel's launch counter to 0."""
    for k in tracer.COUNTS:
        tracer.COUNTS[k] = 0


def launch_counts() -> dict:
    """Every kernel's launches since :func:`reset_launch_counts`, by the
    kernel's name: B2's default and parity instantiations apart, and of
    B5's launches the rich instantiation's under ``"B5 rich"``."""
    return dict(tracer.COUNTS)
