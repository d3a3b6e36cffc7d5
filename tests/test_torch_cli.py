"""The port's command line (``python -m srt_tpu_torch``) on the CPU, against
the in-process render and the JAX package's command line: both engines,
``--checkpoint``, a ``.ppm`` output, ``--list-scenes`` and the aliases,
and the PNG writer on ``zlib`` and ``struct`` alone. The PNG holds the
in-process tonemapped render's 8-bit values exactly, and agrees with
JAX's command line output under the image contract on the 8-bit scale;
the JSON metrics line carries every key of JAX's."""
from __future__ import annotations

import json
import os
import warnings

import numpy as np
import pytest
import torch

from srt_tpu import cli as jax_cli
from srt_tpu_torch import RenderConfig, cli, get_scene, render, render_regen
from srt_tpu_torch.io.image import read_png, read_ppm, write_png
from srt_tpu_torch.render import film
from srt_tpu_torch.scene.library import list_scenes
from srt_tpu_torch.utils import cache, contract

torch.set_num_threads(1)

ARGS = ["--scene", "boxes", "--width", "16", "--spp", "4", "--max-depth",
        "4", "--sample-chunk", "2", "--metrics"]
CFG = dict(width=16, height=16, spp=4, max_depth=4, sample_chunk=2)


@pytest.fixture(autouse=True)
def default_cache():
    """The command line names the build directory; put it back after."""
    yield
    cache.enable()


@pytest.fixture(scope="module")
def boxes():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene("cornell_boxes", device="cpu")
    return scene, cam


def _run(main, argv, capsys) -> dict:
    """Run a command line's ``main``; its JSON metrics line from stderr."""
    assert main(argv) == 0
    err = capsys.readouterr().err.strip().splitlines()
    return json.loads(err[-1])


def _eight_bit(img: torch.Tensor) -> np.ndarray:
    return film.to_uint8(film.tonemap(img)).numpy()


@pytest.mark.parametrize("engine", ["regen", "scan"])
def test_cli_renders_like_the_library_and_jax(engine, boxes, tmp_path,
                                              capsys):
    scene, cam = boxes
    out = str(tmp_path / "port.png")
    line = _run(cli.main, ARGS + ["--engine", engine, "--device", "cpu",
                                  "--out", out], capsys)
    png = read_png(out)
    fn = render_regen if engine == "regen" else render
    np.testing.assert_array_equal(png, _eight_bit(fn(scene, cam,
                                                     RenderConfig(**CFG))))
    jax_out = str(tmp_path / "jax.png")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        line_j = _run(jax_cli.main, ARGS + ["--engine", engine,
                                            "--no-compile-cache", "--out",
                                            jax_out], capsys)
    contract.check_image(png / 255.0, read_png(jax_out) / 255.0)
    assert set(line_j) <= set(line), set(line_j) - set(line)
    assert line["engine"] == engine and line["nan_pixels"] == 0
    assert line["bounce"] == "B2" and line["walk"] == "B3"
    assert line["primary_rays"] == 16 * 16 * 4
    assert line["device"] == "cpu"
    assert line["launches"] == {}     # the CPU runs the plain versions


def test_cli_checkpoint_and_ppm(boxes, tmp_path, capsys):
    """``--checkpoint`` is the resumable scan render whatever the engine:
    its image is the scan render's, and the file is gone at the end; a
    ``.ppm`` output holds the same 8-bit values as the PNG would."""
    scene, cam = boxes
    ckpt = str(tmp_path / "ck.npz")
    out = str(tmp_path / "ck.ppm")
    line = _run(cli.main, ARGS + ["--checkpoint", ckpt, "--checkpoint-every",
                                  "2", "--device", "cpu", "--out", out],
                capsys)
    np.testing.assert_array_equal(
        read_ppm(out), _eight_bit(render(scene, cam, RenderConfig(**CFG))))
    assert not os.path.exists(ckpt)
    assert line["engine"] == "regen" and line["bounce"] == "B2"


def test_cli_lists_scenes_and_takes_aliases(tmp_path, capsys):
    assert cli.main(["--list-scenes"]) == 0
    names = capsys.readouterr().out.split()
    assert names == list_scenes() and "ball_scenes" in names
    out = str(tmp_path / "balls.png")
    line = _run(cli.main, ["--scene", "balls", "--width", "8", "--spp", "1",
                           "--max-depth", "2", "--device", "cpu", "--out",
                           out, "--metrics", "--no-compile-cache",
                           "--max-tex", "4"], capsys)
    assert line["scene"] == "balls" and line["bounce"] == "B1"
    assert read_png(out).shape == (8, 8, 3)
    for alias, name in (("boxes", "cornell_boxes"), ("cornell",
                                                     "cornell_box")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a, _, _ = get_scene(alias, device="cpu")
            b, _, _ = get_scene(name, device="cpu")
        assert torch.equal(a.rect_k, b.rect_k)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jade, _, info = get_scene("jade", device="cpu")
        assert torch.equal(jade.rect_k,
                           get_scene("jadebunny_scene", device="cpu")[0].rect_k)
    assert "models/bunny.ply" in info["skipped"]
    with pytest.raises(KeyError):
        get_scene("no_such_scene", device="cpu")


def test_max_tex_downsamples_image_textures():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        full, _, _ = get_scene("earth_sphere", device="cpu")
        small, _, _ = get_scene("earth_sphere", device="cpu", max_tex=4)
    assert full.tex_img[:, 1:].max() > 4 >= small.tex_img[:, 1:].max()


def test_write_png_round_trip(tmp_path):
    """``write_png`` -> ``read_png`` gives JAX's 8-bit values
    (``clip(255.99 x)``, ``srt_tpu/io/image.py:45-48``), and Pillow
    decodes the same."""
    from PIL import Image
    x = np.random.default_rng(4).uniform(-0.2, 1.2, (9, 13, 3))
    path = str(tmp_path / "x.png")
    write_png(path, x)
    want = np.clip(255.99 * x, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png(path), want)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), want)
