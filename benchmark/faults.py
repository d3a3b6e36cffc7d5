"""Faults planted under the timed path, to show that the check catches
them: the tests drive a run with each, and ``tools/readings.py`` reads
each on the card to bound the limits from above.

A render can leave out half of its samples and take the mean over the
rest (``half_batch``), return an image altered where it is produced
(``altered``: every pixel 1% brighter), or one altered in a tenth of it
(``local``: every tenth row 1% brighter; a fault in one branch of the
film, in one material or at a tile's edge leaves most pixels right). A
train step can leave the parameters as they were (``unchanged``: Adam takes no step), leave out
half of the pixels and take the mean over the rest (``half_batch``), or
produce an altered loss (``altered``: 1% more, the gradient with it).
The cells run on one chip, so no exchange between chips can be left out.
"""
from __future__ import annotations

import contextlib
import dataclasses

RENDER_FAULTS = ("half_batch", "altered", "local")
TRAIN_FAULTS = ("unchanged", "half_batch", "altered")


def _render_wrapper(real, kind: str):
    def fault(scene, camera, config, **kw):
        if kind == "half_batch":
            return real(scene, camera,
                        dataclasses.replace(config, spp=config.spp // 2),
                        **kw)
        out = real(scene, camera, config, **kw)
        img, m = out if kw.get("metrics") else (out, None)
        if kind == "local":
            img = img.clone()
            img[::10] *= 1.01
        else:
            img = img * 1.01
        return (img, m) if kw.get("metrics") else img
    return fault


@contextlib.contextmanager
def planted(kind: str, entry: str):
    """Plant fault ``kind`` under ``entry`` (a traffic's ``entry``) for
    the block: the program's functions the harness reaches are wrapped."""
    import srt_tpu_torch as port
    from srt_tpu_torch.diff import inverse

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    try:
        if entry in ("render_regen", "render"):
            if kind not in RENDER_FAULTS:
                raise ValueError(f"no render fault {kind!r}")
            patch(port, entry, _render_wrapper(getattr(port, entry), kind))
        elif kind == "unchanged":
            real_adam = inverse.adam

            def adam(params, lr=1e-2):
                opt = real_adam(params, lr)
                opt.step = lambda *a, **k: None
                return opt
            patch(inverse, "adam", adam)
        elif kind in ("half_batch", "altered"):
            real_loss = inverse.image_loss

            def image_loss(params, scene, camera, target, pixel_ids, **kw):
                if kind == "half_batch":
                    return real_loss(params, scene, camera, target[::2],
                                     pixel_ids[::2], **kw)
                return real_loss(params, scene, camera, target, pixel_ids,
                                 **kw) * 1.01
            patch(inverse, "image_loss", image_loss)
        else:
            raise ValueError(f"no train fault {kind!r}")
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
