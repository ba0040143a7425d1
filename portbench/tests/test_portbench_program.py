"""The program's spans and counters in a traced run (``program.py``): the
idle gaps refined by the program span the host was in, the readings on a
hand-made summary, and ``Tracing`` over the port's tracer on the CPU."""
from __future__ import annotations

import pytest

from portbench import program, trace
from portbench.tests.test_portbench_trace import SPANS, TRACE, WINDOW

T0 = 1_000_000.0  # the trace's base, epoch µs

# The first batch's program spans, and one span of the host outside any
# harness span: [name, start µs, end µs, parent, frame].
EVENTS = [
    ["native.call", T0 + 11, T0 + 14, "ops.preprocess_fused", None],
    ["ops.preprocess_fused", T0 + 9.5, T0 + 29, "pipeline.batch", None],
    ["pipeline.batch", T0 + 9, T0 + 30, None, None],
    ["serve.stage", T0 + 50, T0 + 55, "serve.submit", 3],
    ["pipeline.batch", T0 + 61, T0 + 79, None, None],
]


def by_prefix(idle: dict) -> dict:
    out = {}
    for name, s in idle.items():
        key = name.split("/", 1)[0]
        out[key] = out.get(key, 0.0) + s
    return out


def test_refined_gaps_name_the_innermost_program_span():
    idle = program.refine_idle(TRACE, SPANS, EVENTS, WINDOW)
    # Gaps: 0-20 (middle 10, in the first batch's wrapper), 35-70 (52.5, in
    # serve.stage outside any harness span), 80-92 and 96-100 (nothing open).
    assert idle == pytest.approx({
        "pipeline.batch/ops.preprocess_fused": 20e-6,
        "host.other/serve.stage": 35e-6,
        "host.other": 16e-6,
    })


@pytest.mark.parametrize("events", [EVENTS, [], EVENTS[:2]], ids=["all", "none", "some"])
def test_refined_gaps_sum_to_the_harness_attribution(events):
    idle = trace.reduce(TRACE, SPANS, WINDOW)["idle"]
    refined = program.refine_idle(TRACE, SPANS, events, WINDOW)
    assert by_prefix(refined).keys() == idle.keys()
    for name, s in idle.items():
        assert by_prefix(refined)[name] == pytest.approx(s, rel=1e-12)


class Result:
    def __init__(self, summary):
        self.trace = summary


PROGRAM = {
    # 100 batches outside the profiled sub-window; spans [count, total s, self s]
    "spans": {
        "pipeline.batch": [100, 6.0e-3, 1.0e-3],
        "ops.preprocess_fused": [100, 5.0e-3, 4.2e-3],
        "ops.warp_affine": [100, 0.5e-3, 0.3e-3],
        "native.call": [100, 1.0e-3, 1.0e-3],
        "serve.submit": [40, 36e-3, 2e-3],
        "serve.stage": [40, 28e-3, 28e-3],
        "serve.slot_wait": [40, 0.4e-3, 0.4e-3],
    },
    "counters": {"native.calls": 200},
    "window_counters": {"native.calls": 220, "serve.h2d_bytes": 70 * 6_220_800},
    "section_counters": {"native.calls": 20, "serve.h2d_bytes": 30 * 6_220_800},
    "events": [],
}
TIMELINE = {"ops": {"Memcpy HtoD (Pinned -> Device)": 7.0e-3, "scale_u8_kernel": 1e-3}}


@pytest.mark.parametrize("reading,want", [
    ("self_us", 10.0), ("wrappers_us", 45.0), ("native_us", 10.0), ("native_calls", 2.0),
    ("tables_made", 0.0), ("stage_us", 700.0), ("slot_wait_us", 10.0),
    ("h2d_gbps", 30 * 6_220_800 / 7.0e-3 / 1e9),
])
def test_readings_of_a_hand_made_summary(reading, want):
    result = Result({"spans": {}, "timeline": TIMELINE, "program": PROGRAM})
    assert getattr(program, reading)(result) == pytest.approx(want)


@pytest.mark.parametrize("reading", ["self_us", "wrappers_us", "native_us", "native_calls",
                                     "tables_made", "stage_us", "slot_wait_us", "h2d_gbps"])
def test_readings_are_none_without_the_programs_summary(reading):
    for summary in ({"spans": {}, "timeline": TIMELINE}, {"spans": {}, "timeline": None,
                                                          "program": None}):
        assert getattr(program, reading)(Result(summary)) is None


def test_tracing_over_a_cpu_window():
    import numpy as np

    from vacv_tpu_torch import config
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor

    pre = Preprocessor(PreprocessConfig(crop_rect=VRect(2, 2, 30, 22), out_size=(8, 8)),
                       device="cpu")
    batch = np.zeros((2, 24, 32, 3), np.uint8)
    tracing = program.Tracing()
    with config.device("cpu"):
        tracing.open()
        for k in range(7):
            if k == 2:
                tracing.start_profile()
            pre.batch(batch)
            if k == 4:
                tracing.stop_profile()
        tracing.close()
    p = tracing.summary(offset_us=1e9)
    assert not tracing.trace.ON
    assert p["spans"]["pipeline.batch"][0] == 4
    assert p["spans"]["ops.preprocess_fused_torch"][0] == 4
    assert p["section_counters"]["preprocess_fused_torch"] == 3
    assert p["window_counters"]["preprocess_fused_torch"] == 7
    assert p["counters"]["preprocess_fused_torch"] == 4
    assert [e[0] for e in p["events"]] == ["ops.preprocess_fused_torch", "pipeline.batch"] * 3
    assert all(e[1] > 1e9 for e in p["events"])
    assert program.native_calls(Result({"program": p})) is None  # no call on the CPU


def test_without_the_tracer_there_is_no_summary(monkeypatch):
    monkeypatch.setattr(program, "tracer", lambda: None)
    tracing = program.Tracing()
    tracing.open()
    tracing.start_profile()
    tracing.stop_profile()
    tracing.close()
    assert tracing.summary(0.0) is None
