"""Worker processes for ``tests/test_torch_dist.py``: each joins a gloo
group through a file under the test's ``tmp_path`` (no TCP port, so
parallel test workers cannot collide), renders or steps on its strip of
pixels on the CPU, and rank 0 saves what it got. Imports no JAX, so a
spawned process starts quickly."""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

#: the JAX package's distribution test scene (``tests/test_dist.py:15-27``)
CAMERA = dict(lookfrom=(5, 3, -8), lookat=(5, 1, 5), vfov=40.0, aspect=1.0,
              aperture=0.0, focus_dist=10.0)
TRAIN = dict(width=16, height=16, spp=4, max_depth=3)


def dist_scene(b):
    """A floor, a red sphere and a rect light; the builder."""
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    red = b.lambertian(b.constant((0.65, 0.05, 0.05)))
    light = b.diffuse_light(b.constant((10.0, 10.0, 10.0)))
    b.xz_rect(0, 10, 0, 10, 0, white)
    b.sphere((5, 1, 5), 1.0, red)
    lid = b.xz_rect(3, 7, 3, 7, 8, light, flip=True)
    b.light_rect(lid)
    return b


def port_scene():
    from srt_tpu_torch.render.camera import Camera
    from srt_tpu_torch.scene.build import SceneBuilder
    return (dist_scene(SceneBuilder()).build("cpu"),
            Camera.look_at(**CAMERA, device="cpu"))


def _join(rank: int, world: int, path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + path,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))


def render_worker(rank: int, world: int, path: str, out: str,
                  cfg: dict) -> None:
    """``render_sharded`` of the scene at ``cfg``; rank 0 saves it."""
    from srt_tpu_torch import RenderConfig
    from srt_tpu_torch.dist import make_mesh, render_sharded

    _join(rank, world, path)
    try:
        scene, cam = port_scene()
        img = render_sharded(scene, cam, RenderConfig(**cfg),
                             make_mesh(device="cpu"))
        if rank == 0:
            np.save(out, img.numpy())
    finally:
        dist.destroy_process_group()


def train_worker(rank: int, world: int, path: str, out: str,
                 target: np.ndarray) -> None:
    """One sharded Adam step of ``{"tex_color"}``; rank 0 saves the loss
    and the parameters, every rank the parameters under its rank."""
    from srt_tpu_torch import make_train_step
    from srt_tpu_torch.dist import make_mesh

    _join(rank, world, path)
    try:
        scene, cam = port_scene()
        if rank:        # rank 0's scene and parameters start every rank
            scene.tex_color.mul_(0.5)
        step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                               mesh=make_mesh(device="cpu"), **TRAIN)
        loss = float(step(torch.from_numpy(target), 0))
        np.savez(os.path.join(out, f"rank{rank}.npz"), loss=loss,
                 tex_color=step.params["tex_color"].detach().numpy())
    finally:
        dist.destroy_process_group()
