"""On the card, at sizes a test run holds: the program's timed entry
passes each cell's limits against the plain reference, and the precision
control (the reference with its throughput and radiance planes in
bfloat16, put in the program's place) fails them.

Run on the card: ``python -m pytest benchmark/tests -m cuda``."""
from __future__ import annotations

import warnings

import pytest
import torch

from _cells import small_cell
from benchmark import check, drivers
from benchmark.reference import path

SEED = 3_000_000_037
#: as many pixels compared as a run of the cell compares: the shares and
#: means that decide ``correct`` are noisier over fewer
RENDER = dict(width=128, height=128, check_pixels=8192, trace_items=1)
TRAIN = dict(width=64, height=64)


def sized(name: str, **size):
    cell = small_cell(name)
    cell.traffic = dict(cell.traffic, **size)
    if cell.traffic["entry"] != "train_step":
        cell.traffic.update(spp=50, max_depth=50, warmup_spp=2,
                            wavefront=1 << 16, sample_chunk=8,
                            pixel_chunk=1 << 16)
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ball_render", "random_render",
                                  "random_scan"])
def test_render_program_passes_and_control_fails(name, card):
    cell = sized(name, **RENDER)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        drv = drivers.RenderDriver(cell, SEED, card)
    drv.warm_up()
    drv.item(0)
    rs, rc = drv.reference_scene()
    t = cell.traffic
    kw = dict(width=t["width"], height=t["height"], spp=t["spp"],
              max_depth=t["max_depth"], seed=drv.item_seed(0))
    ids = torch.as_tensor(drv.pixels, device=card)
    ref = path.render_pixels(rs, rc, ids, **kw)[0].cpu().numpy()
    ctl = path.render_pixels(rs, rc, ids, planes=torch.bfloat16,
                             **kw)[0].cpu().numpy()
    ok, _, _ = check.judge(check.render_numbers(drv.kept[0], ref),
                           cell.limits)
    bad, _, _ = check.judge(check.render_numbers(ctl, ref), cell.limits)
    assert ok and not bad


@pytest.mark.cuda
def test_train_program_passes_and_control_fails(card):
    cell = sized("ball_train", **TRAIN)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        drv = drivers.TrainDriver(cell, SEED, card)
    drv.warm_up()
    t = cell.traffic
    rs, rc = drv.reference_scene()
    p0 = drv.arrays["tex_color"]
    kw = dict(lr=t["lr"], width=t["width"], height=t["height"],
              spp=t["spp"], max_depth=t["max_depth"])
    seeds = [drv.item_seed(k) for k in range(t["check_steps"])]

    def ref_run(planes):
        r = path.adam_steps(rs, rc, torch.as_tensor(p0, device=card),
                            drv.target.reshape(-1, 3), seeds, planes=planes,
                            **kw)
        return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in r.items()}

    ref = ref_run(torch.float32)
    ok, _, _ = check.judge(check.train_numbers(drv.first, ref, p0),
                           cell.limits)
    bad, _, _ = check.judge(check.train_numbers(ref_run(torch.bfloat16), ref,
                                                p0), cell.limits)
    assert ok and not bad
