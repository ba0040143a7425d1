"""The reduction of a profiled sub-window, and the readers over it, on a
hand-made trace: two batches whose kernels overlap, a gap between them."""
from __future__ import annotations

import pytest

from portbench import manifest, trace
from portbench.loops import Run

# Epoch µs = baseTimeNanoseconds / 1e3 + ts.
BASE_NS = 1_000_000_000
SPANS = [("pipeline.batch", 1_000_010.0, 1_000_030.0), ("pipeline.batch", 1_000_060.0, 1_000_080.0)]
WINDOW = (1_000_000.0, 1_000_100.0)


def launch(ts, corr):
    return {"cat": "cuda_runtime", "ts": ts, "dur": 2, "args": {"correlation": corr}}


def kernel(name, ts, dur, corr):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


TRACE = {"baseTimeNanoseconds": BASE_NS, "traceEvents": [
    launch(12, 1), kernel("a", 20, 10, 1),
    launch(14, 2), kernel("b", 25, 10, 2),      # overlaps a: union 15 µs
    launch(62, 3), kernel("a", 70, 10, 3),
    launch(90, 4), kernel("stray", 92, 4, 4),   # launched outside a batch span
]}


def test_reduce_sums_the_sub_window():
    t = trace.reduce(TRACE, SPANS, WINDOW)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(29e-6)
    assert t["kernels_s"]["pipeline.batch"] == pytest.approx(25e-6)
    assert t["kernels_s"]["host.other"] == pytest.approx(4e-6)
    assert t["span_counts"] == {"pipeline.batch": 2}
    assert t["launched_in_spans"] == 3
    assert sum(t["idle"].values()) == pytest.approx(71e-6)
    assert t["ops"]["a"] == pytest.approx(20e-6)


class Result:
    def __init__(self, run, summary):
        self.run, self.trace = run, summary
        self.cfg = self.traffic = self.kind = None


def test_idle_share_at_the_unprofiled_pace():
    timeline = trace.reduce(TRACE, SPANS, WINDOW)
    # 102 batches in 1.05 s, 2 of them in a 0.05 s profiled section: 10 ms a
    # batch outside it, 12.5 µs of device time a batch inside.
    summary = {"spans": {"pipeline.batch": [100, 0.5]}, "timeline": timeline, "section_s": 0.05}
    result = Result(Run(steps=102, elapsed_s=1.05), summary)
    idle = manifest.reader("device.idle_pct")(result)
    assert idle == pytest.approx(100 * (1 - 12.5e-6 / 10e-3))
    assert manifest.reader("pipeline.host_us")(result) == pytest.approx(5000.0)


def test_idle_share_reads_nothing_without_a_profile():
    summary = {"spans": {"pipeline.batch": [100, 0.5]}, "timeline": None, "section_s": 0.0}
    assert manifest.reader("device.idle_pct")(Result(Run(steps=100, elapsed_s=1.0), summary)) is None
