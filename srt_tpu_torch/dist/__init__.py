"""Distribution over ``torch.distributed`` (counterpart of
``srt_tpu/dist``): the pixel axis split over processes."""
from srt_tpu_torch.dist.sharding import (Mesh, make_mesh, pmean,
                                         render_sharded, replicate_scene)

__all__ = ["Mesh", "make_mesh", "pmean", "render_sharded",
           "replicate_scene"]
