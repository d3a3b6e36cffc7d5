"""The device trace of a few renders or train steps: ``torch.profiler``
with CUPTI, read in memory.

Device busy is the union of the intervals in which a device operation
(kernel, copy, set) ran; a kernel's time is the sum of its launches'
durations. The benchmark's own spans (``bench.*``, around each call into
the program, from the harness's files) label the idle gaps: a gap takes
the innermost span that was open on the host when it began.
"""
from __future__ import annotations

import contextlib
import re
import time
import warnings

import torch

SPAN_PREFIX = "bench."


def short(name: str, width: int = 120) -> str:
    """A device operation's name without ``void`` and its argument list,
    at most ``width`` characters: ``void ns::kernel<2, true>(Args)``
    becomes ``ns::kernel<2, true>``."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:width]
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:width]


def span(name: str):
    """A host span of the harness, recorded by the profiler when it runs
    (``record_function``; nothing otherwise)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class DeviceTrace:
    """The device operations and the harness's spans of one profiled
    window, and the window's wall (profiler on)."""

    def __init__(self, ops: list, spans: list, window_s: float):
        self.ops = sorted(ops, key=lambda o: o[1])      # (name, t0, t1) ns
        self.spans = spans                              # (name, t0, t1) ns
        self.window_s = window_s

    @property
    def busy_s(self) -> float:
        busy, end = 0, None
        for _, t0, t1 in self.ops:
            if end is None or t0 >= end:
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy * 1e-9

    def kernels(self) -> list:
        """The kernel launches (copies and sets left out)."""
        return [o for o in self.ops
                if not o[0].startswith(("Memcpy", "Memset"))]

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Total device seconds and launches of the kernels whose name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [o for o in self.kernels() if rx.search(o[0])]
        return sum(t1 - t0 for _, t0, t1 in hits) * 1e-9, len(hits)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the harness span open when each began."""
        by_name: dict = {}
        for name, t0, t1 in self.ops:
            by_name[name] = by_name.get(name, 0) + (t1 - t0)
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for (_, _, a1), (_, b0, _) in zip(self.ops, self.ops[1:]):
            if b0 > a1:
                gaps.append((a1, b0 - a1))
        gaps.sort(key=lambda g: -g[1])
        idle = []
        for t, dur in gaps[:top]:
            open_spans = [s for s in self.spans if s[1] <= t < s[2]]
            label = (min(open_spans, key=lambda s: s[2] - s[1])[0]
                     if open_spans else "outside the harness's spans")
            idle.append([label, dur * 1e-9])
        return {"device_ops": [[n, ns * 1e-9] for n, ns in device_ops],
                "idle_gaps": idle}


@contextlib.contextmanager
def profiled():
    """Profile the block on the host and the card; yields a list that
    receives the :class:`DeviceTrace` when the block ends. Without a card
    (a test's run) the trace holds the host's spans and no device
    operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out: list = []
    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CPU]
            + ([ProfilerActivity.CUDA] if card else [])) as prof:
        warnings.filterwarnings("ignore", message=".*clears events.*")
        t0 = time.perf_counter()
        yield out
        sync()
        window = time.perf_counter() - t0
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.name().startswith(SPAN_PREFIX):
            # a span shows on the host and, mirrored, on the device's
            # timeline: only the host's is kept, and it is no operation
            if e.device_type() != DeviceType.CUDA:
                spans.append((e.name()[len(SPAN_PREFIX):], t0, t1))
        elif e.device_type() == DeviceType.CUDA:
            ops.append((short(e.name()), t0, t1))
    out.append(DeviceTrace(ops, spans, window))
