"""srt_tpu_torch — the path tracer ported to PyTorch and CUDA.

The JAX package ``srt_tpu`` is the reference; this package imports neither
it nor JAX. It covers the scenes its coverage gate admits
(``scene.ir.require_covered``) with two engines: the regeneration render
engine, one hand-written CUDA kernel launch per bounce
(``csrc/regen_bounce.cu``), or on scenes with triangles a BVH walk
(``csrc/intersect_tris.cu``, or ``csrc/intersect_big.cu`` over the
two-level BVH of a large mesh) and a bounce kernel (``csrc/bounce.cu``)
a bounce; and the inverse-rendering train step (``diff.make_train_step``),
whose bounce is a CUDA forward kernel (``csrc/bounce.cu``) and a CUDA
backward kernel (``csrc/bounce_bwd.cu``).
Entry points put their tensors on the card unless the caller passes
``device="cpu"``.
"""
from srt_tpu_torch.diff import make_train_step
from srt_tpu_torch.render.api import RenderConfig
from srt_tpu_torch.render.regen import render_regen
from srt_tpu_torch.scene.library import get_scene

__all__ = ["RenderConfig", "get_scene", "make_train_step", "render_regen"]
