"""The general generator: one closed-loop client driving the program's
public entry points with the parameters of a traffic file.

``entry`` in the traffic picks the call: ``render_regen`` or ``render``
(renders back to back, each with a new sample seed, each ending in its
image read back to the host) or ``train_step`` (the steps of one
``make_train_step`` object, each with a new sample seed, their losses
read back once the window has closed). Set-up builds the program's scene from the
configuration's arrays and warms up the cell's own shapes; the window
then runs for a number of seconds; the traced pass profiles a few more
items; the check runs the plain reference once the program is freed.
"""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

import srt_tpu_torch as port
from srt_tpu_torch import convert

from benchmark import check, spec
from benchmark.reference import path
from benchmark.reference.camera import camera_from
from benchmark.reference.scene import Scene
from benchmark.trace import profiled, span


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    """What every driver shares: the cell, the run's seed, the device, the
    configuration's arrays and the program's scene and camera, and the
    seconds of each phase of set-up (``setup``)."""

    def __init__(self, cell: spec.Cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.t = cell.traffic
        self.setup: dict = {}
        with self.phase("card context"):
            torch.empty(1, device=self.device)
        with self.phase("scene arrays"):
            self.arrays, self.cam_arrays = cell.scene()
        with self.phase("program scene"):
            self.scene = convert.scene_from_arrays(self.arrays,
                                                   device=device)
            self.camera = convert.camera_from_arrays(self.cam_arrays,
                                                     device=device)
        self.walls: list = []
        self.failed = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase of set-up into ``setup``, the card synchronised."""
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.setup[name] = time.perf_counter() - t0

    def item_seed(self, k: int) -> int:
        return spec.derive(self.seed, self.t["entry"], k)

    def window(self, seconds: float) -> None:
        """Items back to back until ``seconds`` have passed; every item
        started completes."""
        t_end = time.perf_counter() + seconds
        k = len(self.walls)
        while True:
            self.walls.append(self.item(k))
            k += 1
            if time.perf_counter() >= t_end:
                return

    def reference_scene(self) -> tuple:
        return (Scene(self.arrays, self.device),
                camera_from(self.cam_arrays, self.device))


class RenderDriver(Driver):
    """``render_regen`` or ``render`` (the scan engine) of the whole image,
    back to back."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        t = self.t
        self.w, self.h, self.spp = t["width"], t["height"], t["spp"]
        n_pix = self.w * self.h
        rng = np.random.default_rng(spec.derive(seed, "pixels"))
        self.pixels = np.sort(rng.choice(n_pix, min(t["check_pixels"],
                                                    n_pix), replace=False))
        self.kept: list = []          # the sampled pixels of every render

    @property
    def fn(self):
        return (port.render_regen if self.t["entry"] == "render_regen"
                else port.render)

    def config(self, k: int, spp: int | None = None):
        t = self.t
        extra = ({"wavefront": t["wavefront"]}
                 if t["entry"] == "render_regen" else
                 {"sample_chunk": t["sample_chunk"],
                  "pixel_chunk": t["pixel_chunk"]})
        return port.RenderConfig(width=self.w, height=self.h,
                                 spp=spp or self.spp,
                                 max_depth=t["max_depth"],
                                 rr_start=t["rr_start"],
                                 seed=self.item_seed(k), **extra)

    def warm_up(self) -> None:
        """One render at the cell's width, height and wavefront (or
        chunks) with ``warmup_spp`` samples: the same kernels and shapes;
        logs the route it took."""
        from srt_tpu_torch.kernels import launch_counts, reset_launch_counts
        reset_launch_counts()
        with self.phase("warm-up render"), torch.no_grad():
            img, m = self.fn(self.scene, self.camera,
                             self.config(-1, self.t["warmup_spp"]),
                             metrics=True)
            img.cpu()
        log(f"[route] {self.t['entry']}: bounce {m.bounce}, walk {m.walk}, "
            f"{m.bounces} bounces for {m.primary_rays} camera rays; "
            f"launches {launch_counts()}")

    def render(self, k: int, metrics: bool = False):
        with span(self.t["entry"]):
            out = self.fn(self.scene, self.camera, self.config(k),
                          metrics=metrics)
        img, m = out if metrics else (out, None)
        with span("readback"):
            host = img.cpu().numpy().reshape(-1, 3)
        return host, m

    def item(self, k: int) -> float:
        t0 = time.perf_counter()
        host, _ = self.render(k)
        wall = time.perf_counter() - t0
        if not np.isfinite(host).all():
            self.failed += 1
        self.kept.append(host[self.pixels].copy())
        return wall

    def end_to_end(self) -> dict:
        rays = self.w * self.h * self.spp
        name = ("render_rays_per_s" if self.t["entry"] == "render_regen"
                else "scan_rays_per_s")
        return {name: len(self.walls) * rays / sum(self.walls)}

    def traced(self) -> dict:
        """Profile ``trace_items`` more renders; count their work."""
        k0 = len(self.walls)
        n = self.t["trace_items"]
        regen = self.t["entry"] == "render_regen"
        ms = []
        with profiled() as out:
            for i in range(n):
                ms.append(self.render(k0 + i, metrics=regen)[1])
        if not regen:   # the scan engine's counters add launches: apart
            ms = [self.render(k0 + i, metrics=True)[1] for i in range(n)]
        return dict(kind="render", items=n, trace=out[0], metrics=ms,
                    wall_per_item=sum(self.walls) / len(self.walls),
                    lanes=min(self.t.get("wavefront", 0),
                              self.w * self.h * self.spp),
                    pixels=self.w * self.h, arrays=self.arrays,
                    traffic=self.t)

    def check(self) -> dict:
        """The sampled pixels of a render drawn from the seed against the
        reference; frees the program's state first."""
        j = spec.derive(self.seed, "check") % len(self.kept)
        prog = self.kept[j]
        del self.scene, self.camera
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        rs, rc = self.reference_scene()
        ref, _ = path.render_pixels(
            rs, rc, torch.as_tensor(self.pixels, device=self.device),
            width=self.w, height=self.h, spp=self.spp,
            max_depth=self.t["max_depth"], seed=self.item_seed(j),
            rr_start=self.t["rr_start"])
        return check.render_numbers(prog, ref.cpu().numpy())


class TrainDriver(Driver):
    """One ``make_train_step`` object, its steps back to back, the first
    ``check_steps`` of them in set-up and compared with the reference."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        t = self.t
        if t["params"] != ["tex_color"]:
            raise ValueError(f"the reference's train step optimises "
                             f"tex_color alone, not {t['params']}")
        self.w, self.h, self.spp = t["width"], t["height"], t["spp"]
        with self.phase("make_train_step"):
            self.step = port.make_train_step(
                self.scene, self.camera,
                {k: getattr(self.scene, k) for k in t["params"]},
                width=self.w, height=self.h, spp=self.spp,
                max_depth=t["max_depth"], lr=t["lr"], engine=t["engine"],
                device=self.device)
            self.target = torch.full((self.h, self.w, 3),
                                     float(t["target"]), device=self.device)
        self.param = self.step.params["tex_color"]
        self.first: dict = {}

    def run_step(self, k: int) -> float:
        with span("train_step"):
            loss = self.step(self.target, self.item_seed(k))
        with span("readback"):
            return float(loss)

    def warm_up(self) -> None:
        """The first ``check_steps`` steps: the optimizer's state after
        the first (its first gradient), each loss, the parameters after
        the last."""
        from srt_tpu_torch.kernels import launch_counts, reset_launch_counts
        reset_launch_counts()
        for k in range(self.t["check_steps"]):
            with self.phase(f"check step {k + 1}"):
                self.first.setdefault("losses", []).append(self.run_step(k))
            if k == 0:    # Adam's first moment after one step: 0.1 g
                m = self.step.optimizer.state[self.param].get("exp_avg")
                self.first["grad1"] = (
                    (m / (1.0 - 0.9)).cpu().numpy() if m is not None else
                    np.full(tuple(self.param.shape), np.nan, np.float32))
        self.first["params"] = self.param.detach().cpu().numpy().copy()
        log(f"[route] train_step engine {self.t['engine']}: first losses "
            f"{self.first['losses']}; launches {launch_counts()}")

    def window(self, seconds: float) -> None:
        """Steps back to back until ``seconds`` have passed, their losses
        kept on the card and read once the window has closed, so that the
        harness adds no wait for the card between steps. A step's wall
        runs from the previous call's return to its own; the last also
        takes the wait for all that was sent, the clock read after it."""
        k = self.t["check_steps"] + len(self.walls)
        losses = []
        t_prev = time.perf_counter()
        t_end = t_prev + seconds
        while True:
            with span("train_step"):
                losses.append(self.step(self.target, self.item_seed(k)))
            k += 1
            now = time.perf_counter()
            self.walls.append(now - t_prev)
            t_prev = now
            if now >= t_end:
                break
        sync(self.device)
        self.walls[-1] += time.perf_counter() - t_prev
        self.failed += int((~torch.isfinite(torch.stack(losses))).sum())

    def end_to_end(self) -> dict:
        return {"train_step_ms": 1e3 * sum(self.walls) / len(self.walls)}

    def phase_walls(self, k: int) -> float:
        """One step with the card synchronised between its phases; returns
        the backward's seconds."""
        step = self.step
        step.optimizer.zero_grad(set_to_none=True)
        sync(self.device)
        loss = step.loss_fn(step.params, step.target(self.target),
                            self.item_seed(k))
        sync(self.device)
        t0 = time.perf_counter()
        loss.backward()
        sync(self.device)
        bwd = time.perf_counter() - t0
        step.optimizer.step()
        float(loss)
        return bwd

    def traced(self) -> dict:
        """Profile ``trace_items`` more steps, time ``trace_items`` more
        phase by phase, and count the live lanes of the profiled ones."""
        k0 = self.t["check_steps"] + len(self.walls)
        n = self.t["trace_items"]
        with profiled() as out:
            for i in range(n):
                self.run_step(k0 + i)
        bwd = [self.phase_walls(k0 + n + i) for i in range(n)]
        # the program's peak, before the reference counts the live lanes
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        rs, rc = self.reference_scene()
        ids = torch.arange(self.w * self.h, device=self.device)
        live = []
        with torch.no_grad():
            for i in range(n):
                rays, salt = path.train_rays(rc, ids, width=self.w,
                                             height=self.h, spp=self.spp,
                                             seed=self.item_seed(k0 + i))
                live.append(sum(path.trace(rs, rays, salt,
                                           max_depth=self.t["max_depth"])[1]))
        del rs, rays, salt
        return dict(kind="train", items=n, trace=out[0], bwd_walls=bwd,
                    memory_peak=peak, step_walls=list(self.walls),
                    wall_per_item=sum(self.walls) / len(self.walls),
                    vertices=live, rays=self.w * self.h * self.spp,
                    arrays=self.arrays, traffic=self.t)

    def check(self) -> dict:
        """The first steps against the reference's; frees the program's
        state first."""
        del self.step, self.param, self.scene, self.camera
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        rs, rc = self.reference_scene()
        target = self.target.reshape(-1, 3)
        p0 = self.arrays["tex_color"]
        ref = path.adam_steps(
            rs, rc, torch.as_tensor(p0, device=self.device), target,
            [self.item_seed(k) for k in range(self.t["check_steps"])],
            lr=self.t["lr"], width=self.w, height=self.h, spp=self.spp,
            max_depth=self.t["max_depth"])
        ref = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
               for k, v in ref.items()}
        return check.train_numbers(self.first, ref, p0)


DRIVERS = {"render_regen": RenderDriver, "render": RenderDriver,
           "train_step": TrainDriver}


def make(cell: spec.Cell, seed: int, device) -> Driver:
    return DRIVERS[cell.traffic["entry"]](cell, seed, device)
