"""Differentiable rendering (counterpart of ``srt_tpu/diff``)."""
from srt_tpu_torch.diff.inverse import (image_loss, make_train_step,
                                        render_pixels, splice)

__all__ = ["image_loss", "make_train_step", "render_pixels", "splice"]
