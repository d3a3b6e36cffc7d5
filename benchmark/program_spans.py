"""The program's own spans and counters (``srt_tpu_torch/trace.py``) in a
traced window, read beside the device trace.

The program records while the profiler runs: each call into it (a
render or a train step) is an entry span with its spans, reads and
launch spans under it, on the profiler's clock. The window is bounded by
the harness's spans (``ctx["trace"].spans``): records that do not lie
inside it are left out. The card's idle holes are the gaps between the
union of the device operations (``ctx["trace"].ops``); a hole takes the
innermost program span that was open on the host when it began, as
``benchmark/trace.py`` labels its gaps by the harness's spans, and a hole
that began outside every program span takes none.

:func:`window` returns None where there is nothing to read: no device
operation (a run without a card), or a program without the tracer (a
checkout from before it), or no call recorded in the window.
"""
from __future__ import annotations

import importlib.util

_CACHE: dict = {}


def holes(ops: list) -> list:
    """The idle holes ``(start, end)`` (ns) between the union of the
    intervals ``ops`` (``(name, t0, t1)``)."""
    out, end = [], None
    for _, t0, t1 in sorted(ops, key=lambda o: o[1]):
        if end is not None and t0 > end:
            out.append((end, t0))
        end = t1 if end is None else max(end, t1)
    return out


class Window:
    """The program's records inside a traced window (``recs``: the
    readout's dicts, ``parent`` an index into ``recs``), the calls
    among them (``entries``), and each idle hole with the record it
    opened in (``gaps``: ``(ns, record or None)``)."""

    def __init__(self, recs: list, lo: int, hi: int, idle: list):
        inside = [i for i, r in enumerate(recs) if r["t1"] is not None
                  and lo <= r["t0"] and r["t1"] <= hi]
        self.recs = recs
        self.entries = [recs[i] for i in inside if recs[i]["parent"] is None]
        self.gaps = _attribute(recs, inside, idle)

    def chain(self, rec: dict) -> list:
        """``rec`` and its ancestors, innermost first."""
        out = [rec]
        while out[-1]["parent"] is not None:
            out.append(self.recs[out[-1]["parent"]])
        return out

    def calls(self, names) -> list:
        """The records of the window's calls whose entry span is named in
        ``names``."""
        calls = {r["call"] for r in self.entries if r["name"] in names}
        return [r for r in self.recs if r["call"] in calls
                and r["t1"] is not None]

    def idle_ms(self, take) -> float:
        """Idle ms per call in the holes whose innermost span ``take``
        accepts, given the span and its ancestors (innermost first)."""
        ns = sum(dur for dur, rec in self.gaps
                 if rec is not None and take(self.chain(rec)))
        return 1e-6 * ns / len(self.entries)


def _attribute(recs: list, inside: list, idle: list) -> list:
    """Each hole ``(start, end)`` with the innermost of the records
    ``inside`` (indices into ``recs``) open at its start (``t0 <= start <
    t1``), by one sweep over both in time order."""
    depth = {}
    for i in inside:
        d, p = 0, recs[i]["parent"]
        while p is not None:
            d, p = d + 1, recs[p]["parent"]
        depth[i] = d
    bounds = sorted([(recs[i]["t0"], 1, i) for i in inside]
                    + [(recs[i]["t1"], 0, i) for i in inside])
    open_: set = set()
    out, k = [], 0
    for start, end in sorted(idle):
        while k < len(bounds) and bounds[k][0] <= start:
            _, is_start, i = bounds[k]
            if is_start:
                open_.add(i)
            else:
                open_.discard(i)
            k += 1
        rec = (recs[max(open_, key=lambda i: (depth[i], recs[i]["t0"]))]
               if open_ else None)
        out.append((end - start, rec))
    return out


def window(ctx: dict) -> Window | None:
    """The program's records of the traced items in ``ctx`` (the traced
    pass of ``benchmark/drivers.py``), or None where there are none."""
    tr = ctx.get("trace")
    if tr is None or not getattr(tr, "ops", None) or not tr.spans:
        return None
    key = id(tr)
    if key in _CACHE and _CACHE[key][0] is tr:
        return _CACHE[key][1]
    win = None
    if importlib.util.find_spec("srt_tpu_torch.trace") is not None:
        from srt_tpu_torch import trace as tracer
        lo = min(s[1] for s in tr.spans)
        hi = max(s[2] for s in tr.spans)
        win = Window(tracer.records(), lo, hi, holes(tr.ops))
        if not win.entries:
            win = None
    _CACHE.clear()
    _CACHE[key] = (tr, win)
    return win
