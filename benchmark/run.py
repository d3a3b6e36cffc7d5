"""Run one cell of the benchmark once and print its result line.

Usage, from the root of a checkout::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic, limits and metrics are read by name
(:mod:`benchmark.spec`). The run loads and warms up (``setup_s``, from
process start to the first measured item), measures for ``--seconds``
with nothing compiling, and with ``--trace 1`` then profiles a few more
items for the per-layer metrics. Once the window has closed and the peak
memory is read, the program's state is freed and the plain reference
decides ``correct``. The last line of standard output is the result; the
last lines of standard error are the numbers compared, each with its
limit. Exits non-zero, printing no result, without a CUDA card (or
fewer than the cell asks for), or if the process holds JAX or the JAX
package once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: top-level modules that may not be loaded in the process that prints
#: the result, compared whole (``srt_tpu_torch`` is not ``srt_tpu``)
FORBIDDEN = ("jax", "jaxlib", "flax", "srt_tpu")


def forbidden_modules() -> list[str]:
    """The :data:`FORBIDDEN` top-level names that ``sys.modules`` holds."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_info() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, cell=None, device="cuda", t_start=None) -> int:
    """One run; returns the exit code. ``cell`` and ``device`` let a test
    drive a run without a card."""
    args = parse(argv)
    import numpy as np
    import torch

    from benchmark import drivers, spec
    from benchmark.check import judge
    t_imported = time.time()
    t_start = t_start if t_start is not None else T_START

    cell = cell if cell is not None else spec.Cell(args.workload)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark measures the card only")
            return 1
        if torch.cuda.device_count() < cell.chips:
            log(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {cell.chips}")
            return 1
        torch.cuda.set_device(dev.index or 0)
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"
    torch.set_num_threads(min(4, torch.get_num_threads()))

    drv = drivers.make(cell, args.seed, dev)
    drv.warm_up()
    drivers.sync(dev)
    t_window = time.time()
    setup_s = t_window - t_start
    drv.window(args.seconds)
    drivers.sync(dev)
    log(f"[setup] {setup_s:.3f} s: imports {t_imported - t_start:.3f} s, "
        + ", ".join(f"{k} {v:.3f} s" for k, v in drv.setup.items()))
    if on_card:
        log(f"[card] {card_info()}; peaks for the roofline shares: "
            f"67 TFLOP/s float32, 3.35 TB/s (H100 SXM at 700 W)")
    q = np.quantile(drv.walls, [0.0, 0.25, 0.5, 0.75, 1.0])
    log(f"[window] {len(drv.walls)} items in {time.time() - t_window:.3f} "
        f"s; item walls min, quartiles, max (s) {q.tolist()}")

    units = {m["name"]: m["unit"] for m in cell.end_to_end
             + cell.per_layer}
    metrics, device_info, breakdown = {}, {}, None
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if args.trace:
        ctx = drv.traced()
        peak = ctx.get("memory_peak", torch.cuda.max_memory_allocated(dev)
                       if on_card else 0)
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        trace = ctx["trace"]
        device_info = {"busy_s": trace.busy_s, "window_s": trace.window_s}
        breakdown = trace.breakdown()
        del ctx
    else:
        values = dict(drv.end_to_end(), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}

    numbers = drv.check()
    correct, compared, other = judge(numbers, cell.limits)
    log(f"[check] reported, no limit: {json.dumps(other)}")
    bad = forbidden_modules()
    if bad:
        log(f"the process holds {bad}: nothing it runs may load JAX or the "
            f"JAX package")
        return 3
    result = {"correct": correct, "attempted": len(drv.walls),
              "failed": drv.failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": kind, "count": cell.chips if on_card else 0,
                         "memory_peak_bytes": peak, **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = compared
    for name, c in compared.items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
