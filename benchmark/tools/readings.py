"""Readings that the correctness limits are set from, at a cell's own size
on the card, many seeds in one process (the program's library and scene
load once).

For each seed: the program's timed entry once (a render, or the first
train steps of a fresh step object) against the plain reference, as a run
compares it; the precision control, the reference with its wavefront's
throughput and radiance kept in bfloat16, against the same reference;
and with ``--faults`` each fault of :mod:`benchmark.faults` planted in
the program. One JSON line a reading on standard output, and the lot in
``--out``.

Usage::

    python3 benchmark/tools/readings.py --workload ball_render \
        --seeds 12 [--control-seeds 3] [--faults] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, drivers, faults, spec  # noqa: E402
from benchmark.reference import path  # noqa: E402


def render_readings(cell, seed: int, dev, control: bool,
                    fault_kinds) -> list:
    drv = drivers.RenderDriver(cell, seed, dev)
    drv.warm_up()
    t = cell.traffic
    out = []
    drv.item(0)
    ids = torch.as_tensor(drv.pixels, device=dev)
    rs, rc = drv.reference_scene()
    kw = dict(width=drv.w, height=drv.h, spp=drv.spp,
              max_depth=t["max_depth"], seed=drv.item_seed(0),
              rr_start=t["rr_start"])
    t0 = time.perf_counter()
    ref, live = path.render_pixels(rs, rc, ids, **kw)
    ref = ref.cpu().numpy()
    ref_s = time.perf_counter() - t0
    out.append(dict(kind="program", ref_s=ref_s, vertices=sum(live),
                    **check.render_numbers(drv.kept[0], ref)))
    if control:
        ctl, _ = path.render_pixels(rs, rc, ids, planes=torch.bfloat16, **kw)
        out.append(dict(kind="control",
                        **check.render_numbers(ctl.cpu().numpy(), ref)))
    for kind in fault_kinds:
        with faults.planted(kind, t["entry"]):
            drv.item(1)
        kw1 = dict(kw, seed=drv.item_seed(1))
        ref1, _ = path.render_pixels(rs, rc, ids, **kw1)
        out.append(dict(kind=kind, **check.render_numbers(
            drv.kept[1], ref1.cpu().numpy())))
        drv.kept.pop()
    return out


def train_readings(cell, seed: int, dev, control: bool,
                   fault_kinds) -> list:
    t = cell.traffic

    def program(kind=None):
        if kind is None:
            drv = drivers.TrainDriver(cell, seed, dev)
            drv.warm_up()
            return drv
        with faults.planted(kind, t["entry"]):
            drv = drivers.TrainDriver(cell, seed, dev)
            drv.warm_up()
        return drv

    drv = program()
    rs, rc = drv.reference_scene()
    p0 = drv.arrays["tex_color"]
    seeds = [drv.item_seed(k) for k in range(t["check_steps"])]
    kw = dict(lr=t["lr"], width=drv.w, height=drv.h, spp=drv.spp,
              max_depth=t["max_depth"])
    target = drv.target.reshape(-1, 3)

    def ref_run(planes=torch.float32):
        r = path.adam_steps(rs, rc, torch.as_tensor(p0, device=dev), target,
                            seeds, planes=planes, **kw)
        return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in r.items()}

    t0 = time.perf_counter()
    ref = ref_run()
    ref_s = time.perf_counter() - t0
    out = [dict(kind="program", ref_s=ref_s,
                **check.train_numbers(drv.first, ref, p0))]
    del drv
    if control:
        out.append(dict(kind="control", **check.train_numbers(
            ref_run(torch.bfloat16), ref, p0)))
    for kind in fault_kinds:
        bad = program(kind)
        out.append(dict(kind=kind, **check.train_numbers(bad.first, ref, p0)))
        del bad
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("readings are taken on the card")
    dev = torch.device("cuda")
    cell = spec.Cell(args.workload)
    train = cell.traffic["entry"] == "train_step"
    kinds = ((faults.TRAIN_FAULTS[1:] if train else faults.RENDER_FAULTS)
             if args.faults else ())
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        ctl = i < args.control_seeds
        fk = kinds if i < args.control_seeds else ()
        fn = train_readings if train else render_readings
        for r in fn(cell, seed, dev, ctl, fk):
            r = dict(workload=args.workload, seed=seed, **r)
            rows.append(r)
            print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    for kind in sorted({r["kind"] for r in rows}):
        sel = [r for r in rows if r["kind"] == kind]
        keys = [k for k in sel[0] if k not in ("workload", "seed", "kind")]
        print(json.dumps({"summary": kind, "n": len(sel), **{
            k: [float(np.min([r[k] for r in sel])),
                float(np.max([r[k] for r in sel]))] for k in keys}}),
              flush=True)


if __name__ == "__main__":
    main()
