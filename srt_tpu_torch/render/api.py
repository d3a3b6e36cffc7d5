"""Render configuration (counterpart of ``srt_tpu/render/api.py:28-71``)."""
from __future__ import annotations

import dataclasses

from srt_tpu_torch.scene.ir import SceneFlags


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """A copy of the JAX package's ``RenderConfig``, field for field, so a
    configuration written for one package runs in the other. The port's
    engine reads ``width height spp max_depth seed rr_start
    sobol_pixel_jitter pdf_floor wavefront ref_parity parity_no_stale``
    (the estimator switches through :func:`scene_flags`); ``seq_stale``
    needs the scan engine and is refused; the chunks configure that
    engine, not ported yet."""
    width: int = 256
    height: int = 256
    spp: int = 64
    max_depth: int = 16
    seed: int = 0
    rr_start: int = 1 << 30          # roulette off (reference parity)
    sample_chunk: int = 8            # scan engine
    pixel_chunk: int = 1 << 16       # scan engine
    sobol_pixel_jitter: bool = True  # Raytracing_n.cpp:834-835
    pdf_floor: float = 1e-9          # zero-contribution mixture-pdf cutoff
    ref_parity: bool = False         # as-implemented reference estimator
    wavefront: int = 1 << 16         # persistent-wavefront lanes (regen)
    parity_no_stale: bool = False    # parity diagnostic: the slot reads 0
    seq_stale: bool = False          # parity scan-engine mode


def scene_flags(scene, config) -> SceneFlags:
    """The scene's flags with the config's estimator switches
    (``srt_tpu/render/api.py:61-71``): ``ref_parity`` and
    ``parity_no_stale``. ``seq_stale`` carries the heap slot across a
    pixel's samples in the scan engine, which the port does not hold yet:
    it raises ``NotImplementedError`` (ROADMAP A6)."""
    if getattr(config, "seq_stale", False):
        raise NotImplementedError(
            "srt_tpu_torch does not cover seq_stale, the scan engine's "
            "sequential parity mode, yet (ROADMAP A6)")
    return SceneFlags.of(scene)._replace(
        ref_parity=bool(getattr(config, "ref_parity", False)),
        parity_no_stale=bool(getattr(config, "parity_no_stale", False)))
