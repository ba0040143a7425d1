"""The port's tracer (``vacv_tpu_torch/utils/trace.py``) on the CPU.

Counters count whether spans are on or not; spans nest, keep their
parents and self time on the tracer's clock (a fake one here, so every
number is exact); events stop at the cap and count what they drop.  The
pipeline and the serving layer open their spans around the wrappers'
(``ops.*``), and a CPU run makes no call into the kernel library; against
a fake library, every launch site counts its call and passes the
argument count its C declaration has."""
import ast
import json
import sys
import types

import numpy as np
import pytest
import torch

from vacv_tpu_torch import config
from vacv_tpu_torch.core.device_tables import stream_cached
from vacv_tpu_torch.core.types import VRect
from vacv_tpu_torch.models import PreprocessConfig, Preprocessor, StreamExecutor
from vacv_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


@pytest.fixture
def tracer():
    """The tracer with spans on and nothing recorded; off again after."""
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.keep_events(False)
    trace.reset()


@pytest.fixture
def clock(monkeypatch):
    """The tracer's clock, set by hand: ``clock.now = t`` (ns)."""
    fake = types.SimpleNamespace(now=0)
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(perf_counter_ns=lambda: fake.now))
    return fake


def at(clock, t, fn, *args):
    clock.now = t
    return fn(*args)


CFG4 = PreprocessConfig(crop_rect=VRect(4, 6, 60, 42), out_size=(16, 12))
CFG5 = PreprocessConfig(crop_rect=VRect(2, 3, 62, 45),
                        warp=(((0.9, 0.03, 4.0), (-0.03, 0.9, 2.0)), (40, 30)), out_size=(16, 12))


def frames(n=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 48, 64, 3), dtype=np.uint8)


def test_off_records_no_span_and_reads_no_clock_but_counts(monkeypatch):
    def no_clock():
        raise AssertionError("a span site read the clock with spans off")

    trace.reset()
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(perf_counter_ns=no_clock))
    before = config.kernel_count("preprocess_fused_torch")
    Preprocessor(CFG4, device="cpu").batch(frames())
    snap = trace.snapshot()
    assert not trace.ON and snap["spans"] == {} and snap["events"] == []
    assert config.kernel_count("preprocess_fused_torch") == before + 1
    trace.count("test.counter", 3)
    assert trace.counter("test.counter") >= 3


def test_nesting_parents_and_self_time(tracer, clock):
    tracer.keep_events(True)
    outer = at(clock, 100, tracer.begin, "outer")
    a = at(clock, 110, tracer.begin, "inner", 7)
    at(clock, 140, tracer.end, a)
    b = at(clock, 150, tracer.begin, "inner")
    leaf = at(clock, 152, tracer.begin, "leaf")
    at(clock, 155, tracer.end, leaf)
    at(clock, 160, tracer.end, b)
    at(clock, 200, tracer.end, outer)
    snap = tracer.snapshot()
    assert snap["spans"] == {
        "outer": {"count": 1, "total_ns": 100, "self_ns": 60},
        "inner": {"count": 2, "total_ns": 40, "self_ns": 37},
        "leaf": {"count": 1, "total_ns": 3, "self_ns": 3},
    }
    assert [(e["name"], e["start_ns"], e["end_ns"], e["parent"], e["seq"])
            for e in snap["events"]] == [
        ("inner", 110, 140, "outer", 7), ("leaf", 152, 155, "inner", None),
        ("inner", 150, 160, "outer", None), ("outer", 100, 200, None, None)]
    json.dumps(snap)  # plain data


def test_the_bookkeeping_stays_out_of_the_parents_self_time(tracer, monkeypatch):
    """On a clock that moves 1 ns a read, ``begin`` and ``end`` each read
    it twice: a span's own time runs from ``begin``'s last read to
    ``end``'s first, its parent counts it from ``begin``'s first read to
    ``end``'s last, and the reads between are the tracer's cost."""
    reads = iter(range(1000))
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(perf_counter_ns=lambda: next(reads)))
    outer = tracer.begin("outer")  # reads 0, 1
    inner = tracer.begin("inner")  # 2, 3
    tracer.end(inner)  # 4, 5
    tracer.end(outer)  # 6, 7
    snap = tracer.snapshot()
    assert snap["spans"] == {"outer": {"count": 1, "total_ns": 5, "self_ns": 2},
                             "inner": {"count": 1, "total_ns": 1, "self_ns": 1}}
    assert snap["cost_ns"] == 4
    tracer.reset()
    assert tracer.snapshot()["cost_ns"] == 0


def test_a_span_left_open_is_dropped_when_its_parent_ends(tracer, clock):
    outer = at(clock, 0, tracer.begin, "outer")
    at(clock, 10, tracer.begin, "raised")  # never ended: an exception passed it
    at(clock, 50, tracer.end, outer)
    after = at(clock, 60, tracer.begin, "next")
    at(clock, 70, tracer.end, after)
    spans = tracer.snapshot()["spans"]
    assert spans == {"outer": {"count": 1, "total_ns": 50, "self_ns": 50},
                     "next": {"count": 1, "total_ns": 10, "self_ns": 10}}


def test_a_span_ends_across_disable_and_reset(tracer, clock):
    span = at(clock, 0, tracer.begin, "a")
    tracer.disable()
    at(clock, 5, tracer.end, span)
    assert tracer.snapshot()["spans"]["a"]["total_ns"] == 5
    tracer.enable()
    span = at(clock, 10, tracer.begin, "b")
    tracer.reset()
    at(clock, 20, tracer.end, span)  # begun before the reset: forgotten
    assert tracer.snapshot()["spans"] == {}


def test_events_stop_at_the_cap_and_count_the_dropped(tracer, clock, monkeypatch):
    monkeypatch.setattr(trace, "EVENT_CAP", 3)
    tracer.keep_events(True)
    dropped = tracer.counter("trace.events_dropped")
    for t in range(5):
        at(clock, 10 * t + 5, tracer.end, at(clock, 10 * t, tracer.begin, "s", t))
    snap = tracer.snapshot()
    assert [e["seq"] for e in snap["events"]] == [0, 1, 2]
    assert snap["spans"]["s"]["count"] == 5
    assert tracer.counter("trace.events_dropped") == dropped + 2
    tracer.keep_events(False)
    at(clock, 100, tracer.end, at(clock, 90, tracer.begin, "s"))
    assert tracer.counter("trace.events_dropped") == dropped + 2


def test_reset_keeps_the_counters(tracer):
    config.record_kernel("test_trace_route")
    tracer.end(tracer.begin("s"))
    tracer.reset()
    assert tracer.snapshot()["spans"] == {}
    assert config.kernel_count("test_trace_route") >= 1
    assert tracer.snapshot()["counters"]["test_trace_route"] == config.kernel_count(
        "test_trace_route")


@pytest.mark.parametrize("cfg,ops", [
    (CFG4, ["ops.preprocess_fused_torch"]),
    (CFG5, ["ops.warp_affine_torch", "ops.preprocess_fused_planar_torch"]),
], ids=["config4", "config5"])
def test_a_cpu_batch_nests_the_wrappers_in_the_pipeline(tracer, cfg, ops):
    tracer.keep_events(True)
    calls = tracer.counter("native.calls")
    Preprocessor(cfg, device="cpu").batch(frames(3))
    events = tracer.snapshot()["events"]
    assert [e["name"] for e in events] == ops + ["pipeline.batch"]
    batch = events[-1]
    for e in events[:-1]:
        assert e["parent"] == "pipeline.batch"
        assert batch["start_ns"] <= e["start_ns"] <= e["end_ns"] <= batch["end_ns"]
    snap = tracer.snapshot()
    spans = snap["spans"]
    inside = spans["pipeline.batch"]["total_ns"] - sum(spans[name]["total_ns"] for name in ops)
    # the children's bookkeeping is left out too, and lies within the tracer's cost
    assert inside - snap["cost_ns"] <= spans["pipeline.batch"]["self_ns"] <= inside
    assert "native.call" not in spans
    assert tracer.counter("native.calls") == calls


def test_the_served_frames_carry_their_numbers(tracer):
    tracer.keep_events(True)
    pre = Preprocessor(CFG4, device="cpu")
    ex = StreamExecutor(pre, depth=2)
    outs = [ex.submit(f) for f in frames(5)]
    outs += list(ex.drain())
    assert sum(o is not None for o in outs) == 5
    events = tracer.snapshot()["events"]
    submits = [e for e in events if e["name"] == "serve.submit"]
    assert [e["seq"] for e in submits] == [0, 1, 2, 3, 4]
    assert all(e["parent"] is None for e in submits)
    assert sorted(e["seq"] for e in events if e["name"] == "serve.hand_over") == [0, 1, 2, 3, 4]
    batches = [e for e in events if e["name"] == "pipeline.batch"]
    assert len(batches) == 5 and all(e["parent"] == "serve.submit" for e in batches)


def test_tables_made_counts_each_miss_once():
    made = []

    @stream_cached(maxsize=8)
    def table(n, device):
        made.append(n)
        return torch.arange(n, device=device)

    cpu = torch.device("cpu")
    before = trace.counter("tables.made")
    table(3, cpu)
    table(3, cpu)
    table(4, cpu)
    table(3, cpu)
    assert made == [3, 4]
    assert trace.counter("tables.made") == before + 2


def test_the_tracer_imports_the_standard_library_alone():
    tree = ast.parse(open(trace.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            names.add(node.module.split(".")[0])
    assert names - {"__future__"} <= set(sys.stdlib_module_names), names


@pytest.fixture
def fake_library(monkeypatch):
    """The kernel library replaced by fakes that hold each call to its C
    declaration's argument count; returns the names called."""
    import ctypes
    import re

    from vacv_tpu_torch.ops.cuda import build, normalize, preprocess

    declared = {}
    for src in sorted(build.SRC_DIR.glob("*.cu")):
        if 'extern "C" {' in (text := src.read_text()):
            block = text.split('extern "C" {', 1)[1]
            for name, params in re.findall(r"^(?:int|const char\*) (vacv_\w+)\(([^)]*)\)",
                                           block, re.M):
                declared[name] = [p for p in params.split(",") if p.strip() not in ("", "void")]
    limits = {"vacv_preprocess_limits": [132, 2048, 232448, 233472],
              "vacv_normalize_limits": [132, 200000, 1, 1024, 32, 16, 1024]}
    called = []

    def fake(name):
        def fn(*args):
            if name in limits:
                out = ctypes.cast(args[1], ctypes.POINTER(ctypes.c_int))
                for i, v in enumerate(limits[name]):
                    out[i] = v
            else:
                assert len(args) == len(declared[name]), name
                called.append(name)
            return 0
        return fn

    lib = types.SimpleNamespace(**{name: fake(name) for name in declared})
    monkeypatch.setattr(build, "library", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    caches = [build.entry, preprocess.card_limits, normalize._limits]
    for c in caches:
        c.cache_clear()
    yield called
    for c in caches:
        c.cache_clear()


@pytest.mark.parametrize("spans", [False, True], ids=["spans_off", "spans_on"])
def test_every_launch_site_counts_its_call_into_the_library(fake_library, spans):
    """Each form of each wrapper's launch, on CPU tensors against the fake
    library: the declared argument count, one ``native.calls`` a call and,
    with spans on, one ``native.call`` span a call inside the wrapper's, and
    one ``ops.<route>`` span a wrapper call."""
    from vacv_tpu_torch.ops.cuda import (
        match_template, normalize, preprocess, probe, warp_affine, window_sum, yuv2bgr,
    )

    trace.reset()
    if spans:
        trace.enable()
    try:
        calls = trace.counter("native.calls")
        bgr = torch.zeros((2, 40, 64, 3), dtype=torch.uint8)
        geom = preprocess._geometry(bgr, VRect(2, 2, 60, 38), (16, 12), "linear", None)
        for form in ("moments", "two_launch", "resize_only"):
            preprocess._prepare(bgr, geom, None, None, None, None, True, True, "linear", "x",
                                preprocess.Plan(form, 4)).run(bgr)
        nv = torch.zeros((2, 60, 64), dtype=torch.uint8)
        geom = preprocess._nv_geometry(nv, None, (16, 12), None)
        for plan in (preprocess.Plan("one_pass", 2, 6, 128), preprocess.Plan("two_launch")):
            preprocess._prepare(nv, geom, (False, False), None, None, None, True, True, "linear",
                                "x", plan).run(nv)
        planes, top = torch.zeros((2, 3, 30, 40), dtype=torch.uint8), torch.tensor(3)
        warp_affine.prepare_warp_planes(planes, np.eye(2, 3), 20, 30, row0=top,
                                        rows=20).run(planes, top)
        hwc = torch.zeros((2, 30, 40, 3), dtype=torch.uint8)
        preprocess.prepare_fused_warp(hwc.permute(0, 3, 1, 2), np.eye(2, 3), 20, 30, (16, 12),
                                      row0=top, rows=20).run(hwc, top)
        normalize._launch(torch.zeros((3, 20, 30), dtype=torch.uint8), "auto")
        yuv2bgr._launch(torch.zeros((20, 30), dtype=torch.uint8),
                        torch.zeros((10, 30), dtype=torch.uint8), False)
        match_template._launch(torch.zeros((3, 40, 50)), torch.zeros((3, 5, 6)))
        window_sum._launch(torch.zeros((3, 40, 50)), 5, 6, True, True)
        probe._launch(torch.zeros((40, 32), dtype=torch.bfloat16),
                      torch.zeros((32, 16), dtype=torch.bfloat16), 8)
        assert fake_library == [
            "vacv_preprocess_moments", "vacv_preprocess_resize", "vacv_preprocess_normalize",
            "vacv_preprocess_resize", "vacv_preprocess_nv_one_pass", "vacv_preprocess_nv_resize",
            "vacv_preprocess_normalize", "vacv_warp_affine", "vacv_preprocess_warp_moments",
            "vacv_normalize_planes", "vacv_yuv2bgr", "vacv_match_corr", "vacv_window_sum",
            "vacv_probe_mma"]
        assert trace.counter("native.calls") - calls == 14
        spans_seen = trace.snapshot()["spans"]
        assert spans_seen.get("native.call", {"count": 0})["count"] == (14 if spans else 0)
        wrapper_calls = {"ops.x": 5, "ops.warp_affine": 1, "ops.preprocess_fused_warp": 1,
                         "ops.normalize_fused": 1,
                         "ops.yuv2bgr": 1, "ops.match_corr": 1, "ops.window_sum": 1,
                         "ops.probe_dot": 1}
        assert {k: v["count"] for k, v in spans_seen.items() if k.startswith("ops.")} == (
            wrapper_calls if spans else {})
    finally:
        trace.disable()
        trace.reset()


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


# each public wrapper of ops/cuda: its route, and a call on tensors it takes, on another device
WRAPPER_CALLS = {
    "preprocess_fused_batch": ("preprocess_fused", lambda m: m.preprocess_fused_batch(
        _meta(2, 40, 64, 3, dtype=torch.uint8), None, (16, 12))),
    "preprocess_fused_nv_batch": ("preprocess_fused_nv", lambda m: m.preprocess_fused_nv_batch(
        _meta(2, 60, 64, dtype=torch.uint8), None, (16, 12))),
    "preprocess_fused_planes": ("preprocess_fused_planar", lambda m: m.preprocess_fused_planes(
        _meta(2, 3, 30, 40, dtype=torch.uint8), (16, 12))),
    "warp_planes_batch": ("warp_affine", lambda m: m.warp_planes_batch(
        _meta(2, 3, 30, 40, dtype=torch.uint8), np.eye(2, 3), 20, 30)),
    "normalize_fused": ("normalize_fused", lambda m: m.normalize_fused(
        _meta(3, 20, 30, dtype=torch.uint8))),
    "nv_to_bgr": ("yuv2bgr", lambda m: m.nv_to_bgr(
        _meta(20, 30, dtype=torch.uint8), _meta(10, 30, dtype=torch.uint8), is_nv12=False)),
    "corr_planes": ("match_corr", lambda m: m.corr_planes(_meta(3, 40, 50), _meta(3, 5, 6))),
    "window_sums": ("window_sum", lambda m: m.window_sums(_meta(3, 40, 50), 5, 6)),
    "probe_dot": ("probe_dot", lambda m: m.probe_dot(
        _meta(40, 32, dtype=torch.bfloat16), _meta(32, 16, dtype=torch.bfloat16), 8)),
}


@pytest.mark.parametrize("wrapper", list(WRAPPER_CALLS))
def test_a_wrapper_on_another_device_names_its_route_and_counts_nothing(tracer, wrapper):
    """Neither the card nor the CPU: ValueError naming the route, no
    counter moved and no span opened."""
    from vacv_tpu_torch.ops import cuda

    route, run = WRAPPER_CALLS[wrapper]
    before = tracer.snapshot()["counters"]
    with pytest.raises(ValueError, match=f"no {route} route for device meta"):
        run(cuda)
    assert tracer.snapshot()["counters"] == before
    assert tracer.snapshot()["spans"] == {}


def test_the_cost_script_splits_a_small_cpu_run(tmp_path):
    """``profile/trace_cost.py`` on small CPU frames: each case's spans a
    call, the children of each, the probe's residual, and the tracer left
    off and the route counts as they were."""
    from vacv_tpu_torch.profile import trace_cost

    count = config.record_kernel
    out = tmp_path / "cost.json"
    results = trace_cost.main(["--small", "--rounds", "1", "--calls", "2", "--frames", "2",
                               "--out", str(out)])
    assert json.loads(out.read_text()) == results
    assert [r["case"] for r in results] == ["config4", "config5", "config4.served"]
    for r, root, children in zip(results, ["pipeline.batch", "pipeline.batch", "serve.submit"],
                                 [1, 2, 2]):
        assert len(r["off_us"]) == len(r["on_us"]) == 1
        assert r["spans"][root]["per_call"] == 1.0
        assert r["spans"][root]["children"] == children
        assert r["residual_ns"] is not None and r["tracer_us"] > 0
        assert r["spans"][root]["self_net_us"] < r["spans"][root]["self_us"]
        assert r["records"] == {"hits": 0, "made": 0, "hit_share": None}  # none on the CPU
    assert not trace.ON and config.record_kernel is count
