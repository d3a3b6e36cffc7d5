"""What the harness reads by name: the cell's entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json`` and the scene generator
``scenes/<scene>.py``), its traffic (``workloads/<traffic>.json``), its
correctness limits (``limits/<cell>.json``) and the readers of its
per-layer metrics (``metrics/<metric>.py``, or the reader its quantity
shares). Adding a cell, a
configuration or a metric adds files; no file here changes.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _json(ROOT, "BENCHMARK.json")


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench if bench is not None else benchmark()
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r}; have {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.config = _json(HERE, "configs", self.entry["config"] + ".json")
        self.traffic = _json(HERE, "workloads",
                             self.entry["traffic"] + ".json")
        self.limits = _json(HERE, "limits", name + ".json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @classmethod
    def from_parts(cls, name: str, entry: dict, config: dict, traffic: dict,
                   limits: dict, end_to_end: list, per_layer: list) -> "Cell":
        """A cell made of given parts rather than read from the files: a
        test's small copy of a cell."""
        cell = cls.__new__(cls)
        cell.name, cell.entry, cell.chips = name, entry, int(entry["chips"])
        cell.config, cell.traffic, cell.limits = config, traffic, limits
        cell.end_to_end, cell.per_layer = end_to_end, per_layer
        return cell

    def scene(self) -> tuple[dict, dict]:
        """The configuration's scene arrays and camera arrays, from its
        generator with the configuration's arguments."""
        mod = importlib.import_module(
            "benchmark.scenes." + self.config["scene"])
        return mod.make(**self.config.get("scene_args", {}))


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``, or where there is no
    such file, of the reader its quantity shares, ``metrics/<q>.py`` for
    ``<q>.<x>``: ``idle_share.scan`` reads as ``idle_share`` does."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(HERE, "metrics", metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def derive(seed: int, *keys) -> int:
    """A 31-bit seed derived from the run's ``--seed`` and ``keys``: the
    sample seed of each render or train step, and the checker's draws."""
    h = hashlib.sha256(":".join(str(k) for k in (seed, *keys)).encode())
    return int.from_bytes(h.digest()[:4], "little") & 0x7FFFFFFF
