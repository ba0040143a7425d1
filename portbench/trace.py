"""Spans of the harness and the profiler's view of one sub-window.

A traced run (``--trace 1``) records a host span around each call into a
layer (``pipeline.batch``, ``serve.submit``, ``gen.wait``) on the
``perf_counter`` clock, and runs ``torch.profiler`` (CUDA activity only:
kernels, copies and the runtime's launch calls) over a bounded sub-window
of the measured one.  ``reduce`` turns that sub-window into a few sums: the
device's busy time, the device time by operation, the idle time by the host
span the host was in, and the device time of the kernels launched inside
each kind of span.  The
profiler's clock is the epoch clock (``baseTimeNanoseconds`` plus each
event's microseconds); the spans are moved onto it by one offset taken when
the profiler starts.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Recorder:
    """Host spans of one run: (count, total seconds) by name outside the
    profiled sub-window, and every span inside it."""

    def __init__(self):
        self.totals = defaultdict(lambda: [0, 0.0])
        self.profiled = []      # (name, start, end) on the perf_counter clock
        self.profiling = False
        self._prof = None
        self._offset_us = 0.0
        self.window = None      # (start, end) of the profiled sub-window, perf_counter s
        self.start_s = 0.0      # what starting the profiler took
        self.section_s = 0.0    # wall time from starting the profiler to its stop returning
        self._section_t0 = 0.0

    def span(self, name: str, t0: float, t1: float) -> None:
        if self.profiling:
            self.profiled.append((name, t0, t1))
        else:
            tot = self.totals[name]
            tot[0] += 1
            tot[1] += t1 - t0

    def warm(self) -> None:
        """Start and stop the profiler once before the window: its first
        start (CUPTI's set-up) takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    def start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        t = self._section_t0 = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.start_s = time.perf_counter() - t
        self._offset_us = min(time.time_ns() / 1e3 - time.perf_counter_ns() / 1e3
                              for _ in range(5))
        self.profiling = True
        self.window = (time.perf_counter(), None)

    def stop_profile(self) -> None:
        """End the sub-window; the device finishes what it was given before
        the profiler stops, so every kernel of the window is recorded."""
        import torch

        self.window = (self.window[0], time.perf_counter())
        self.profiling = False
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.section_s = time.perf_counter() - self._section_t0

    def summary(self) -> dict:
        """What the per-layer readers read (JSON-ready)."""
        if self.profiling:
            self.stop_profile()
        out = {"spans": {k: list(v) for k, v in self.totals.items()}, "timeline": None,
               "section_s": self.section_s}
        if self._prof is not None and self.window[1] is not None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    trace = json.load(f)
            finally:
                os.remove(path)
            to_us = lambda t: t * 1e6 + self._offset_us  # noqa: E731
            spans = [(n, to_us(a), to_us(b)) for n, a, b in self.profiled]
            out["timeline"] = reduce(trace, spans, (to_us(self.window[0]), to_us(self.window[1])))
            out["timeline"]["profiler_start_s"] = self.start_s
        return out


def _union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def reduce(trace: dict, spans: list, window: tuple) -> dict:
    """Sums over the sub-window ``window`` (epoch µs) of a Chrome trace and
    the host ``spans`` (name, start µs, end µs) made in it."""
    base = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    w0, w1 = window
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    launches, device = {}, []
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = e["ts"] + base
        elif cat in DEVICE_CATS and e.get("dur") is not None:
            start = e["ts"] + base
            device.append((e["name"], cat, start, start + e["dur"], args.get("correlation")))
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][1] <= t <= spans[i][2]:
            return spans[i][0]
        return None

    clipped = [(max(a, w0), min(b, w1)) for _, _, a, b, _ in device if b > w0 and a < w1]
    busy = _union(clipped)
    ops = defaultdict(float)
    by_span = defaultdict(list)
    inside = 0
    for name, _, a, b, corr in device:
        if b > w0 and a < w1:
            ops[name] += (min(b, w1) - max(a, w0)) / 1e6
        launched = launches.get(corr, a)
        if not w0 <= launched <= w1:
            continue
        where = span_at(launched)
        inside += where is not None
        by_span[where or "host.other"].append((a, b))
    # Idle gaps: the window less the device's busy intervals, each put to
    # the host span at its middle.
    idle = defaultdict(float)
    t = w0
    for a, b in sorted(clipped) + [(w1, w1)]:
        if a > t:
            idle[span_at((t + a) / 2) or "host.other"] += (a - t) / 1e6
        t = max(t, b)
    counts = defaultdict(int)
    for name, _, _ in spans:
        counts[name] += 1
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "ops": dict(ops),
        "idle": dict(idle),
        "kernels_s": {k: _union(v) / 1e6 for k, v in by_span.items()},
        "span_counts": dict(counts),
        "device_events": len(device),
        "launched_in_spans": inside,
    }
