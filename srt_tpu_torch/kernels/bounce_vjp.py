"""The bounce as a differentiable function: forward kernel B2, backward
kernel B5 (counterpart of ``srt_tpu/pallas/bounce_vjp.py:_bounce_core``,
``:89-117``).

:class:`BounceCore` saves only the bounce's inputs; its backward launches
the VJP kernel on them. The JAX package's split core defers the image
texture epilogue outside its custom VJP; the port folds the image lookup
into both kernels, and its cotangent in the uv is zero (nearest-neighbour
lookup), so nothing is left outside. On CPU tensors both directions are
the plain versions, the backward being ``torch.autograd`` of the plain
step. The hybrid backward that linearises the plain bounce for geometry
gradients (``bounce_vjp.py:40-84``) is not ported (ROADMAP A13).
"""
from __future__ import annotations

import torch

from srt_tpu_torch.kernels.bounce import StepSpec, bounce_fwd
from srt_tpu_torch.kernels.bounce_bwd import ROWS, bounce_bwd
from srt_tpu_torch.scene.ir import SceneFlags, TorchScene


class BounceCore(torch.autograd.Function):
    """``(o, d, beta, radiance, mat) -> (o', d', beta', radiance', depth',
    alive')`` with the state's integer fields and the scene as constants.
    Differentiable in the four (N, 3) rows and the (M, 14) material
    table."""

    @staticmethod
    def forward(ctx, o, d, beta, radiance, mat, time, salt, depth, alive,
                scene: TorchScene, flags: SceneFlags, tables: dict,
                spec: StepSpec):
        state = dict(o=o, d=d, beta=beta, radiance=radiance, time=time,
                     salt=salt, depth=depth, alive=alive)
        tabs = dict(tables, mat=mat)
        out = bounce_fwd(scene, flags, tabs, state, spec)
        ctx.save_for_backward(o, d, beta, radiance, mat, salt, depth, alive)
        ctx.statics = (scene, flags, tables, spec, time)
        ctx.mark_non_differentiable(out["depth"], out["alive"])
        return (out["o"], out["d"], out["beta"], out["radiance"],
                out["depth"], out["alive"])

    @staticmethod
    def backward(ctx, g_o, g_d, g_beta, g_rad, _g_depth, _g_alive):
        o, d, beta, radiance, mat, salt, depth, alive = ctx.saved_tensors
        scene, flags, tables, spec, time = ctx.statics
        state = dict(o=o, d=d, beta=beta, radiance=radiance, time=time,
                     salt=salt, depth=depth, alive=alive)
        ct = dict(zip(ROWS, (g_o, g_d, g_beta, g_rad)))
        d_state, d_mat = bounce_bwd(scene, flags, dict(tables, mat=mat),
                                    state, ct, spec)
        return (d_state["o"], d_state["d"], d_state["beta"],
                d_state["radiance"], d_mat) + (None,) * 8


def bounce_core(scene: TorchScene, flags: SceneFlags, tables: dict,
                state: dict, spec: StepSpec) -> dict:
    """One differentiable bounce of ``state`` (see
    ``kernels.bounce.bounce_step_ref`` for its fields). Gradients reach
    ``tables["mat"]`` and, through it, the parameters it was built from."""
    o, d, beta, radiance, depth, alive = BounceCore.apply(
        state["o"], state["d"], state["beta"], state["radiance"],
        tables["mat"], state["time"], state["salt"], state["depth"],
        state["alive"], scene, flags, tables, spec)
    return dict(o=o, d=d, beta=beta, radiance=radiance, depth=depth,
                alive=alive, time=state["time"], salt=state["salt"])
