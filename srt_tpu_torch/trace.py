"""The program's tracer: spans and counters inside the port, recorded while
a ``torch.profiler`` runs, on the profiler's clock.

A span records its name, its start and end (``time.time_ns``, the Unix
epoch's nanoseconds, the clock of the profiler's events), its parent
span, the call into the program it belongs to (a render or a train step:
every span of one call shares its id), whether it is a *read* (the host
waits for the card in it: a ``.tolist()``, an ``int()``, a synchronise)
and its attributes. A launch span (``B1`` ... ``B6``, ``film_sum``,
``segment_sum``) carries ``lanes``, the launch's lane count; a B2 or B5
launch also ``live``, the lanes live on entry (those B5 sweeps), which
the kernel counts into a slot of a device array this module owns (zeroed
once a call) and which is read only when the records are
(:func:`records`).

Whether a call records is decided once, at its entry span
(:func:`entry`): while the profiler's own is-enabled query says a
profiler runs. Its spans read one module flag, :data:`ON`; when it is
off a span is that check, B2 and B5 pass a null counter and nothing
is allocated, recorded or read. Spans are not mirrored into the profiler
(``record_function``), whose ranges would show on the card's timeline.

The records live in memory, at most :data:`MAX_RECORDS`; past them a
record is dropped and counted (:func:`dropped`). :func:`write_chrome`
writes them as Chrome trace events. Launch counts (:data:`COUNTS`,
``kernels.launch_counts``) are kept whether or not a call records. One
thread records at a time: the autograd engine's device thread records
the backward's launches while the caller waits in ``backward()``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch

#: whether the running call records; set by its :func:`entry` span
ON = False
#: the records the buffer holds at most
MAX_RECORDS = 1 << 18
#: live-lane slots in one device array; a call that fills one takes another
SLOTS = 8192
#: the kernels whose launches are counted, by ``kernels.launch_counts``'s
#: names (``B5 rich`` is of ``B5``'s launches the rich instantiation's)
KERNELS = ("B1", "B2", "B2 parity", "B3", "B4", "B5", "B5 rich", "B6",
           "film_sum", "segment_sum")
#: launches of each kernel on the card since ``reset_launch_counts``
COUNTS = dict.fromkeys(KERNELS, 0)

#: the clock of every span, the profiler's
now = time.time_ns

_records: list = []     # [name, t0, t1, parent, call, read, attrs]
_stack: list = []       # the open spans' indices, -1 for a dropped one
_dropped = 0
_calls = 0              # calls recorded so far; the running call's id
_slots = None           # [device array, next free slot] of the running call
_NULL = contextlib.nullcontext()


class _Slot:
    """A launch's live-lane count: slot ``k`` of a device array."""
    __slots__ = ("array", "k")

    def __init__(self, array: torch.Tensor, k: int):
        self.array, self.k = array, k


class _Events:
    """A span's pair of CUDA events; its device time once both ran."""
    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start, self.end = start, end


def _open(name: str, read: bool, attrs: dict) -> int:
    global _dropped
    if len(_records) >= MAX_RECORDS:
        _dropped += 1
        _stack.append(-1)
        return -1
    parent = _stack[-1] if _stack else -1
    _records.append([name, now(), None, parent if parent >= 0 else None,
                     _calls, read, attrs])
    _stack.append(len(_records) - 1)
    return len(_records) - 1


def _close(i: int) -> None:
    _stack.pop()
    if i >= 0:
        _records[i][2] = now()


@contextlib.contextmanager
def _span(name: str, read: bool, attrs: dict):
    i = _open(name, read, attrs)
    try:
        yield attrs
    finally:
        _close(i)


def span(name: str, read: bool = False):
    """A span of the running call (a context manager), a read where the
    host waits for the card in it; nothing when the call does not
    record."""
    if not ON:
        return _NULL
    return _span(name, read, {})


@contextlib.contextmanager
def _entry(name: str):
    global ON, _calls, _slots
    ON = True
    _calls += 1
    try:
        with _span(name, False, {}) as attrs:
            yield attrs
    finally:
        ON = False
        _slots = None


def entry(name: str):
    """The span of a call into the program (``render_regen``, ``render``,
    ``train_step``): it records, with every span inside it, while a
    ``torch.profiler`` runs. Yields the span's attributes, which the call
    may fill, or None when it does not record. Inside a recording call
    it is a span of that call."""
    if ON:
        return _span(name, False, {})
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _entry(name)


@contextlib.contextmanager
def _phase(name: str, device: torch.device):
    attrs: dict = {}
    stream = None
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        ev = _Events(torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
        ev.start.record(stream)
        attrs["device_ms"] = ev
    with _span(name, False, attrs):
        try:
            yield
        finally:
            if stream is not None:
                ev.end.record(stream)


def phase(name: str, device):
    """A span of the train step that, on the card, also records a pair of
    CUDA events on the current stream: its ``device_ms`` at readout, with
    no synchronise on the way."""
    if not ON:
        return _NULL
    return _phase(name, torch.device(device))


def launch(name: str, t0: int, lanes: int, live=None) -> None:
    """Record a launch span that began at ``t0`` and ends now, with its
    lane count and, for B2 and B5, its live lanes (a slot of
    :func:`live_slot` or a tensor). Called where :data:`ON` is set."""
    global _dropped
    if len(_records) >= MAX_RECORDS:
        _dropped += 1
        return
    attrs = {"lanes": lanes}
    if live is not None:
        attrs["live"] = live
    parent = _stack[-1] if _stack else -1
    _records.append([name, t0, now(), parent if parent >= 0 else None,
                     _calls, False, attrs])


def live_slot(device) -> tuple[int, _Slot]:
    """A zeroed int64 slot on ``device`` for one launch's live-lane
    count: its address, for the kernel, and its handle, for the launch
    span. The running call zeroes one array of :data:`SLOTS` slots, when
    it first asks, and another each time it has used them all."""
    global _slots
    device = torch.device(device)
    if _slots is None or _slots[1] == SLOTS or _slots[0].device != device:
        _slots = [torch.zeros(SLOTS, dtype=torch.int64, device=device), 0]
    array, k = _slots
    _slots[1] = k + 1
    return array.data_ptr() + 8 * k, _Slot(array, k)


def _resolve(value, arrays: dict):
    if isinstance(value, _Slot):
        key = id(value.array)
        if key not in arrays:
            arrays[key] = value.array.tolist()
        return arrays[key][value.k]
    if isinstance(value, _Events):
        value.end.synchronize()
        return value.start.elapsed_time(value.end)
    if isinstance(value, torch.Tensor):
        return value.item()
    return value


def records() -> list[dict]:
    """The records so far, oldest first: ``name``, ``t0`` and ``t1``
    (ns, the profiler's clock), ``parent`` (an index into the list, or
    None), ``call``, ``read`` and ``attrs``. The device's values (live
    lanes, a phase's ``device_ms``, a render's ``path_vertices``) are
    read here, once: this waits for the card."""
    arrays: dict = {}
    for rec in _records:
        attrs = rec[6]
        for k, v in attrs.items():
            if isinstance(v, (_Slot, _Events, torch.Tensor)):
                attrs[k] = _resolve(v, arrays)
    return [dict(name=r[0], t0=r[1], t1=r[2], parent=r[3], call=r[4],
                 read=r[5], attrs=dict(r[6])) for r in _records]


def dropped() -> int:
    """Records dropped since :func:`clear` because the buffer was full."""
    return _dropped


def clear() -> None:
    """Empty the buffer and the dropped count."""
    global _dropped
    _records.clear()
    _dropped = 0


def write_chrome(path: str) -> int:
    """Write :func:`records` to ``path`` as Chrome trace events (``ph``
    ``X``, ``ts`` and ``dur`` in µs of the Unix epoch, with
    ``baseTimeNanoseconds`` 0, the profiler's own trace giving its ``ts``
    after its ``baseTimeNanoseconds``; the process's id, a track a call);
    returns how many."""
    recs = records()
    events = [{"name": r["name"], "ph": "X", "cat": "srt",
               "ts": r["t0"] / 1e3, "dur": (r["t1"] - r["t0"]) / 1e3,
               "pid": os.getpid(), "tid": r["call"],
               "args": dict(r["attrs"], read=r["read"], call=r["call"])}
              for r in recs if r["t1"] is not None]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": 0,
                   "displayTimeUnit": "ms", "dropped": dropped()}, f)
    return len(events)
