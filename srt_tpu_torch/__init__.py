"""srt_tpu_torch — the path tracer ported to PyTorch and CUDA.

The JAX package ``srt_tpu`` is the reference; this package imports neither
it nor JAX. It renders every scene of the JAX package's builder and
library (the scanned meshes loaded by ``io/mesh.py``, MERL measured BRDFs,
packed and float image atlases) with two render engines:

* :func:`render`, the scan engine (``render/api.py``): a chunk of pixels ×
  samples traced as one wavefront over ``max_depth`` lockstep bounces,
  each bounce a launch of the bounce kernel (``csrc/bounce.cu``) after, on
  a triangle scene, a BVH walk (``csrc/intersect_tris.cu``, or
  ``csrc/intersect_big.cu`` over the two-level BVH of a large mesh); with
  checkpoints and resume in ``utils/checkpoint.py:render_resumable``;
* :func:`render_regen`, the regeneration engine: one launch of the
  regeneration kernel (``csrc/regen_bounce.cu``, lean, or rich for the
  specular branch, media, checker, marble and image textures and sphere
  lights) a bounce, or on triangle scenes and under the parity estimator
  the walk and the bounce kernel a bounce.

A scene the bounce kernels' gate refuses (MERL, mesh-bounded media, past
their table caps) takes the plain bounce in either engine
(``render/route.py``). The inverse-rendering train step
(``diff.make_train_step``, either engine) runs the bounce kernel forward
and the backward kernel (``csrc/bounce_bwd.cu``) or the hybrid backward;
an optimised image atlas takes the hybrid. ``dist`` splits the pixels of
a render or a train step over processes (``torch.distributed``;
``python -m srt_tpu_torch.dist.multihost``).
The command line is ``python -m srt_tpu_torch`` (``cli.py``). Entry
points put their tensors on the card unless the caller passes
``device="cpu"``.
"""
from srt_tpu_torch.diff import make_train_step
from srt_tpu_torch.render.api import RenderConfig, render
from srt_tpu_torch.render.regen import render_regen
from srt_tpu_torch.scene.library import get_scene

__all__ = ["RenderConfig", "get_scene", "make_train_step", "render",
           "render_regen"]
