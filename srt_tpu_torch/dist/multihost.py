"""Multi-process entry (counterpart of ``srt_tpu/dist/multihost.py``): the
same sharded render over processes joined by ``torch.distributed``.

Typical launch, one process per card (on each host, or several on one)::

    python -m srt_tpu_torch.dist.multihost --coordinator 10.0.0.1:29500 \\
        --num-processes 4 --process-id $RANK --scene cornell --spp 256

Each process renders its strip of pixels on its device
(:func:`dist.sharding.render_sharded`); process 0 writes the image. With
one process there is no process group, and the render is the sharded
render over a one-process mesh. ``--backend`` picks ``nccl`` (the default
on the card: one process per card) or ``gloo`` (the CPU, or several
processes sharing one card, which NCCL refuses).
"""
from __future__ import annotations

import argparse
import datetime
import sys


def init_multihost(coordinator: str | None, num_processes: int,
                   process_id: int, backend: str | None = None,
                   device: str = "cuda") -> None:
    """``torch.distributed.init_process_group`` over ``num_processes``
    processes meeting at ``coordinator`` (``host:port``, or an
    ``init_method`` URL such as ``file://...``), this one of rank
    ``process_id``; ``backend`` defaults to ``nccl`` for the card and
    ``gloo`` for the CPU. A no-op for one process, as JAX's is."""
    if num_processes <= 1:
        return
    import torch.distributed as dist
    if coordinator is None:
        raise ValueError("several processes need --coordinator host:port")
    method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if backend is None:
        backend = "nccl" if str(device).startswith("cuda") else "gloo"
    dist.init_process_group(backend, init_method=method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(minutes=10))


def global_mesh(device=None):
    """The mesh over every process of the group (one device each)."""
    from srt_tpu_torch.dist.sharding import make_mesh
    return make_mesh(device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="srt_tpu_torch.dist.multihost")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--scene", default="cornell_boxes")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=16)
    ap.add_argument("--out", default="out.png",
                    help=".png, .ppm, or .npy for the linear image")
    ap.add_argument("--device", default="cuda",
                    help="torch device type of every process")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on the card, gloo on the CPU")
    args = ap.parse_args(argv)

    init_multihost(args.coordinator, args.num_processes, args.process_id,
                   args.backend, args.device)

    import numpy as np
    import torch.distributed as dist

    from srt_tpu_torch.dist.sharding import render_sharded
    from srt_tpu_torch.io.image import write_png, write_ppm
    from srt_tpu_torch.render import film
    from srt_tpu_torch.render.api import RenderConfig
    from srt_tpu_torch.scene.library import get_scene

    try:
        mesh = global_mesh(args.device)
        scene, camera, _ = get_scene(args.scene, aspect=1.0,
                                     device=mesh.device)   # height == width
        config = RenderConfig(width=args.width, height=args.width,
                              spp=args.spp, max_depth=args.max_depth)
        img = render_sharded(scene, camera, config, mesh)
        if mesh.rank == 0:
            if args.out.lower().endswith(".npy"):
                np.save(args.out, img.cpu().numpy())
            elif args.out.lower().endswith(".ppm"):
                write_ppm(args.out, film.tonemap(img).cpu().numpy())
            else:
                write_png(args.out, film.tonemap(img).cpu().numpy())
            print(f"wrote {args.out} from {mesh.size} process(es) "
                  f"({mesh.backend or 'no process group'}) on "
                  f"{mesh.device}", file=sys.stderr)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
