"""The backward's wall of a train step timed phase by phase (the card
synchronised after the forward and after the backward), the mean over
the traced steps, in ms. Layer: ``diff/inverse.py:make_train_step`` and
``kernels/bounce_vjp.py`` (B5 and the material sum). Moves
``train_step_ms``."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("bwd_walls"):
        return None
    return 1e3 * sum(ctx["bwd_walls"]) / len(ctx["bwd_walls"])
