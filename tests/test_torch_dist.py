"""Distribution over ``torch.distributed`` against one process and the
JAX package (``srt_tpu/dist``, ``tests/test_dist.py``): two gloo
processes on the CPU render the one-process image to the bit and take the
one-process train step within JAX's bounds (loss 1e-6, parameters 1e-5);
the multi-process entry point with one process; the mesh and its strips.

Each worker process joins its group through a file under the test's
``tmp_path`` (parallel test workers cannot collide on a port), is spawned
with ``torch.multiprocessing`` and joined with a timeout, then killed if
it is still running."""
from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from _torch_dist import (CAMERA, TRAIN, dist_scene, port_scene,
                         render_worker, train_worker)

from srt_tpu import RenderConfig as JaxRenderConfig
from srt_tpu.dist import make_mesh as jax_make_mesh
from srt_tpu.dist import render_sharded as jax_render_sharded
from srt_tpu.render.camera import Camera as JaxCamera
from srt_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from srt_tpu_torch import RenderConfig, make_train_step, render
from srt_tpu_torch.dist import make_mesh, multihost, render_sharded
from srt_tpu_torch.dist.sharding import strip
from srt_tpu_torch.io.image import read_png
from srt_tpu_torch.render import film
from srt_tpu_torch.utils import contract

torch.set_num_threads(1)

RENDER = dict(width=16, height=16, spp=8, max_depth=4)
TIMEOUT = 240       # seconds for a group of worker processes


def _spawn(fn, args: tuple, world: int = 2) -> None:
    """``fn(rank, *args)`` in ``world`` spawned processes, joined within
    :data:`TIMEOUT` seconds; a process still running then is killed and
    the test fails."""
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} did not end in "
                                   f"{TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def test_two_processes_render_one_process_image(tmp_path):
    """Two gloo processes (pixel strips of 128) give the one-process
    image to the bit, and so does a render whose pixel count does not
    divide (15x15: padded to 226); both equal ``render``'s, the scan
    engine's own loop in one process."""
    scene, cam = port_scene()
    for cfg in (RENDER, dict(RENDER, width=15, height=15)):
        out = str(tmp_path / f"img{cfg['width']}.npy")
        _spawn(render_worker, (2, str(tmp_path / f"pg{cfg['width']}"), out,
                               cfg))
        two = np.load(out)
        one = render_sharded(scene, cam, RenderConfig(**cfg),
                             make_mesh(device="cpu"))
        assert np.array_equal(two.view(np.int32), one.numpy().view(np.int32))
        assert torch.equal(one, render(scene, cam, RenderConfig(**cfg)))


def test_sharded_render_matches_jax():
    """The port's sharded render (one process) against JAX's
    ``render_sharded`` over its 8-device CPU mesh, on the same scene,
    under the image contract."""
    if len(jax.devices()) < 8:
        pytest.skip("needs JAX's 8 virtual CPU devices (tests/conftest.py)")
    scene_j = dist_scene(JaxSceneBuilder()).build()
    cam_j = JaxCamera.look_at(**CAMERA)
    want = np.asarray(jax_render_sharded(scene_j, cam_j,
                                         JaxRenderConfig(**RENDER),
                                         jax_make_mesh(8)))
    scene, cam = port_scene()
    got = render_sharded(scene, cam, RenderConfig(**RENDER),
                         make_mesh(device="cpu"))
    contract.check_image(got.numpy(), want)


def test_sharded_train_step_matches_single(tmp_path):
    """One Adam step of two gloo processes (each its 128-pixel strip, the
    loss and gradient averaged over the ranks) against the one-process
    step: the loss within 1e-6, the parameters within 1e-5 (JAX's
    ``test_train_step_sharded_matches_single``). Rank 1 starts from other
    colours; rank 0's start both, so both ranks end equal."""
    scene, cam = port_scene()
    n = TRAIN["width"] * TRAIN["height"]
    target = np.random.default_rng(0).uniform(0.1, 0.5, (n, 3)).astype(
        np.float32)
    _spawn(train_worker, (2, str(tmp_path / "pg"), str(tmp_path), target))
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))
    step = make_train_step(scene, cam, {"tex_color": scene.tex_color},
                           device="cpu", **TRAIN)
    loss = float(step(torch.from_numpy(target), 0))
    assert abs(float(r0["loss"]) - loss) < 1e-6
    want = step.params["tex_color"].detach().numpy()
    np.testing.assert_allclose(r0["tex_color"], want, atol=1e-5)
    assert np.array_equal(r0["tex_color"], r1["tex_color"])
    assert not np.array_equal(want, scene.tex_color.numpy())


def test_multihost_main_one_process(tmp_path):
    """``python -m srt_tpu_torch.dist.multihost`` with one process (no
    group): the linear image equal to ``render``'s, and the PNG its
    tonemap."""
    npy, png = str(tmp_path / "x.npy"), str(tmp_path / "x.png")
    args = ["--scene", "cornell_boxes", "--width", "12", "--spp", "2",
            "--max-depth", "3", "--device", "cpu"]
    assert multihost.main(args + ["--out", npy]) == 0
    assert multihost.main(args + ["--out", png]) == 0
    from srt_tpu_torch import get_scene
    scene, cam, _ = get_scene("cornell_boxes", device="cpu")
    want = render(scene, cam, RenderConfig(width=12, height=12, spp=2,
                                           max_depth=3))
    assert np.array_equal(np.load(npy), want.numpy())
    assert np.array_equal(read_png(png), film.to_uint8(film.tonemap(want))
                          .numpy())
    with pytest.raises(ValueError, match="coordinator"):
        multihost.init_multihost(None, 2, 0)


def test_mesh_and_strips():
    """Without a process group the mesh is one rank on the given device;
    a mesh of another size raises; the strips pad the pixel axis to a
    multiple of the world size (``sharding.py:60-68``)."""
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    assert mesh.backend is None
    with pytest.raises(ValueError, match="processes"):
        make_mesh(2, device="cpu")
    assert strip(mesh, 10) == (0, 10)
    parts = [strip(type(mesh)(4, r, mesh.device), 10)
             for r in range(4)]
    assert parts == [(0, 3), (3, 6), (6, 9), (9, 12)]


def test_mesh_device_is_the_card_unless_named(tmp_path):
    """The mesh's device is the card whatever the group's backend (a gloo
    group too), the CPU only when named; a train step given a device
    that is not its mesh's raises rather than train elsewhere."""
    import torch.distributed as dist
    assert make_mesh().device == torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method="file://"
                            + str(tmp_path / "pg"), world_size=1, rank=0)
    try:
        assert make_mesh().device == torch.device("cuda", 0)
        assert make_mesh(device="cpu").device == torch.device("cpu")
        assert make_mesh().backend == "gloo"
    finally:
        dist.destroy_process_group()
    scene, cam = port_scene()
    for device, mesh in (("cuda", make_mesh(device="cpu")),
                         ("cpu", make_mesh())):
        with pytest.raises(ValueError, match="mesh's"):
            make_train_step(scene, cam, {"tex_color": scene.tex_color},
                            mesh=mesh, device=device, **TRAIN)
