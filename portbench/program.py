"""The program's own spans and counters in a traced run, and what they show.

The port traces itself (``vacv_tpu_torch/utils/trace.py``): spans in
``Preprocessor.batch`` (``pipeline.batch``), the CUDA wrappers (``ops.*``),
the calls into the kernel library (``native.call``) and ``StreamExecutor``
(``serve.*``), and counters of those calls, the device tables made and the
bytes a served frame sends.  The harness's spans (``trace.py``) wrap one
call into the port each; these split that call into its parts.

``Tracing`` drives the tracer over a traced window: ``open`` as the window
opens (spans on), ``start_profile`` and ``stop_profile`` beside the
``Recorder``'s (events kept in between), ``close`` as the window ends.
``summary`` gives the window's spans and counters outside the profiled
sub-window, the sub-window's counters and its events on the profiler's
epoch clock.  ``refine_idle`` puts each idle gap of the sub-window under
the innermost program span open at its middle, named ``<harness
span>/<program span>``.  The functions at the end are the per-layer
readings, ``f(result) -> float or None``, of a result whose ``trace`` holds
that summary under ``"program"``.

A tree whose program has no tracer gives no summary, and every reading is
then None.
"""
from __future__ import annotations

import bisect

from .trace import DEVICE_CATS


def tracer():
    """The port's tracer module, or None where the program has none."""
    try:
        from vacv_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


class Tracing:
    """The program's tracer over one traced window: a snapshot at each mark."""

    def __init__(self):
        self.trace = tracer()
        self.marks: dict[str, dict] = {}

    def _mark(self, name: str) -> None:
        self.marks[name] = self.trace.snapshot()

    def open(self) -> None:
        if self.trace is not None:
            self.trace.reset()
            self.trace.enable()
            self._mark("open")

    def start_profile(self) -> None:
        if self.trace is not None:
            self._mark("start")
            self.trace.keep_events(True)

    def stop_profile(self) -> None:
        if self.trace is not None:
            self.trace.keep_events(False)
            self._mark("stop")

    def close(self) -> None:
        if self.trace is not None:
            self._mark("end")
            self.trace.disable()
            self.trace.keep_events(False)

    def summary(self, offset_us: float) -> dict | None:
        """``{"spans": {name: [count, total s, self s]}, "counters": {name:
        n}}`` of the window outside the profiled sub-window, with
        ``"window_counters"`` (the whole window), ``"section_counters"``
        and ``"events"`` (``[name, start µs, end µs, parent, frame]``, on
        the epoch clock: ``perf_counter`` µs + ``offset_us``) of the
        sub-window; None without a tracer or a closed window."""
        m = self.marks
        if "open" not in m or "end" not in m:
            return None
        empty = {"spans": {}, "counters": {}, "events": []}
        start = m.get("start", empty)
        stop = m.get("stop", m["end"] if "start" in m else empty)  # the window ended first
        whole_spans, whole_counts = _since(m["open"], m["end"])
        cut_spans, cut_counts = _since(start, stop)
        spans = {}
        for name, (c, t, s) in whole_spans.items():
            cc, ct, cs = cut_spans.get(name, (0, 0, 0))
            if c > cc:
                spans[name] = [c - cc, (t - ct) / 1e9, (s - cs) / 1e9]
        events = [[e["name"], e["start_ns"] / 1e3 + offset_us, e["end_ns"] / 1e3 + offset_us,
                   e["parent"], e["seq"]] for e in stop["events"]]
        return {
            "spans": spans,
            "counters": {k: v - cut_counts.get(k, 0) for k, v in whole_counts.items()},
            "window_counters": whole_counts,
            "section_counters": cut_counts,
            "events": events,
        }


def _since(a: dict, b: dict):
    """({name: (count, total ns, self ns)}, {name: n}) recorded between
    snapshots ``a`` and ``b``."""
    spans = {}
    for name, v in b["spans"].items():
        u = a["spans"].get(name, {"count": 0, "total_ns": 0, "self_ns": 0})
        if v["count"] > u["count"]:
            spans[name] = (v["count"] - u["count"], v["total_ns"] - u["total_ns"],
                           v["self_ns"] - u["self_ns"])
    counts = {k: n - a["counters"].get(k, 0) for k, n in b["counters"].items()
              if n != a["counters"].get(k, 0)}
    return spans, counts


def refine_idle(trace: dict, spans: list, events: list, window: tuple) -> dict:
    """Idle seconds of the sub-window ``window`` (epoch µs) by the span the
    host was in at each gap's middle: ``<harness span>/<program span>``
    where a program span (``events``, as ``summary`` gives them) was open,
    the innermost; the harness span alone (``spans``: name, start µs, end
    µs), or ``host.other``, where none was.  Summed by harness span, these
    are ``trace.reduce``'s ``idle``."""
    base = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    w0, w1 = window
    device = []
    for e in trace["traceEvents"] if isinstance(trace, dict) else trace:
        if e.get("cat") in DEVICE_CATS and e.get("dur") is not None:
            a = e["ts"] + base
            if a + e["dur"] > w0 and a < w1:
                device.append((max(a, w0), min(a + e["dur"], w1)))
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]

    def harness_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][1] <= t <= spans[i][2]:
            return spans[i][0]
        return "host.other"

    gaps, t = [], w0
    for a, b in sorted(device) + [(w1, w1)]:
        if a > t:
            gaps.append(((t + a) / 2, (a - t) / 1e6))
        t = max(t, b)
    order = sorted(events, key=lambda e: e[1])
    open_, i = [], 0
    idle: dict[str, float] = {}
    for mid, seconds in gaps:
        while i < len(order) and order[i][1] <= mid:
            while open_ and open_[-1][2] < order[i][1]:
                open_.pop()  # ended before this one began: not its parent
            open_.append(order[i])
            i += 1
        while open_ and open_[-1][2] < mid:
            open_.pop()
        name = harness_at(mid)
        if open_:
            name = f"{name}/{open_[-1][0]}"
        idle[name] = idle.get(name, 0.0) + seconds
    return idle


# --- the per-layer readings -------------------------------------------------


def _program(result) -> dict | None:
    return (result.trace or {}).get("program")


def _per_batch(result, value) -> float | None:
    """``value(program)`` over the ``pipeline.batch`` spans outside the
    profiled sub-window; None where either is missing."""
    p = _program(result)
    batches = p and p["spans"].get("pipeline.batch", (0,))[0]
    v = value(p) if batches else None
    return None if v is None else v / batches


def self_us(result):
    """The self time of ``pipeline.batch`` a batch, µs: the route, the crop
    arguments, views and the pipeline's own host work."""
    s = _per_batch(result, lambda p: p["spans"]["pipeline.batch"][2])
    return None if s is None else s * 1e6


def wrappers_us(result):
    """The self time of the wrappers' ``ops.*`` spans a batch, µs: checks,
    plans, table lookups, allocations, argument packing."""
    s = _per_batch(result, lambda p: sum(v[2] for k, v in p["spans"].items()
                                         if k.startswith("ops.")) or None)
    return None if s is None else s * 1e6


def native_us(result):
    """The time in calls into the kernel library a batch, µs
    (``native.call``)."""
    s = _per_batch(result, lambda p: p["spans"].get("native.call", (0, None))[1])
    return None if s is None else s * 1e6


def native_calls(result):
    """Calls into the kernel library a batch (``native.calls``)."""
    return _per_batch(result, lambda p: p["counters"].get("native.calls"))


def tables_made(result):
    """Device tables made in the whole measured window (``tables.made``)."""
    p = _program(result)
    return None if p is None else float(p["window_counters"].get("tables.made", 0))


def _mean_us(result, name):
    p = _program(result)
    count, total, _ = (p or {"spans": {}})["spans"].get(name, (0, 0.0, 0.0))
    return total / count * 1e6 if count else None


def stage_us(result):
    """The copy of a served frame into its pinned slot (``serve.stage``)."""
    return _mean_us(result, "serve.stage")


def slot_wait_us(result):
    """The wait for a slot's previous copy to leave it (``serve.slot_wait``)."""
    return _mean_us(result, "serve.slot_wait")


def h2d_gbps(result):
    """GB/s of the served frames' copies to the card: ``serve.h2d_bytes``
    counted in the profiled sub-window over the device time of its ``Memcpy
    HtoD`` operations."""
    p, t = _program(result), (result.trace or {}).get("timeline")
    if not p or not t:
        return None
    sent = p["section_counters"].get("serve.h2d_bytes", 0)
    busy = sum(s for name, s in t["ops"].items() if name.startswith("Memcpy HtoD"))
    return sent / busy / 1e9 if sent and busy > 0 else None
