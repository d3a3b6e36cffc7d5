"""The per-bounce route of the render engines: which walk finds a triangle
scene's closest hits and which bounce shades them, chosen once a render on
the host from the scene's flags.

The bounce is kernel B2 (:func:`kernels.bounce.bounce_fwd`) wherever the
JAX package's gate admits its fused bounce kernel (``_use_fused_bounce``,
``srt_tpu/render/regen.py:44-58``, over ``_fused_bounce_eligible``,
``srt_tpu/scene/ir.py:133-160``): no more than 4,096 spheres, 64 rects,
8 lights, 512 materials and 8 media, no mesh-bounded medium. Elsewhere it
is the plain bounce (:func:`kernels.bounce.bounce_step_ref`), as the JAX
package sends those scenes to its XLA bounce; the triangles are still
walked by B3 or B4. JAX's gate also keeps roulette off its kernel on
scenes with noise or image albedo, because that kernel multiplies such
albedo into the throughput after the survival test; the port's B2
multiplies it in before, as JAX's XLA bounce does, so it needs no such
refusal (``tests/test_torch_gate.py`` holds two_perlin_spheres' noise
albedo under roulette against both of JAX's engines).

No route catches a kernel's build or launch error: a failure raises.
"""
from __future__ import annotations

import torch

from srt_tpu_torch.kernels import bounce as kb
from srt_tpu_torch.kernels import intersect as ki
from srt_tpu_torch.render.intersect import (intersect_tris,
                                            intersect_tris_big, two_level)
from srt_tpu_torch.scene.ir import SceneFlags, TorchScene


class Route:
    """One bounce of an explicit wavefront state, ``route(state) ->
    next``, as :func:`kernels.bounce.bounce_step_ref` describes the state;
    depth cap not applied. ``bounce`` names the shading (``"B2"`` or
    ``"plain"``) and ``walk`` the triangle walk (``"B3"``, ``"B4"``,
    ``"plain"``, or None without triangles); ``steps`` counts the calls.
    On CPU tensors the kernels are their plain versions. ``plain=True``
    takes the plain versions on any device (how the kernels' image is
    checked on the card)."""

    def __init__(self, scene: TorchScene, flags: SceneFlags,
                 spec: kb.StepSpec, plain: bool = False):
        self.scene, self.flags, self.spec = scene, flags, spec
        self.tables = kb.build_tables(scene, flags)
        self.plain = plain
        self.bounce = "B2" if flags.fused_bounce and not plain else "plain"
        self.walk = None
        if scene.n_tris:
            big = two_level(scene)
            if plain:
                self.walk = "plain"
                self._plain_walk = (intersect_tris_big if big
                                    else intersect_tris)
            else:
                self.walk = "B4" if big else "B3"
                self._packed = ki.pack_walk(scene)
        self.steps = 0

    def hits(self, o: torch.Tensor, d: torch.Tensor):
        """Each ray's closest triangle ``(t, u, v, idx)``."""
        if self.plain:
            return self._plain_walk(self.scene, o, d,
                                    leaf_size=self.flags.bvh_leaf)
        return ki.closest_tris(self.scene, self._packed, o, d)

    def __call__(self, state: dict) -> dict:
        self.steps += 1
        tri = (self.hits(state["o"], state["d"]) if self.walk is not None
               else None)
        if self.bounce == "B2":
            return kb.bounce_fwd(self.scene, self.flags, self.tables, state,
                                 self.spec, tri)
        return kb.bounce_step_ref(self.scene, self.flags, self.tables["mat"],
                                  state, self.spec, tri)
