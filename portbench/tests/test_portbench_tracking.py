"""The tracking deployment's files: the ``nv_tracking`` chain and the
``tracking`` loop kind on the CPU at a small size, the seven readers of
``tracking.loop`` on a hand-made trace (with the frame's operation and byte
counts at the configuration's shapes), and the cell's wiring in
``BENCHMARK.json``."""
from __future__ import annotations

import pytest
import torch

from portbench import check, manifest, run, trace
from portbench.loops import Run
from portbench.tests.helpers import small_cell

BENCH = manifest.load()
CELL = manifest.cell(BENCH, "tracking.loop")
CFG = manifest.config(BENCH, CELL)
CHAIN = manifest.chain(CFG)
H100 = "NVIDIA H100 80GB HBM3"
SEED = 2**31 + 99
READERS = ["track.host_us", "track.replay_share", "track.idle_pct", "track.roofline",
           "track.corr_roofline", "track.sums_roofline", "track.nv_roofline"]


def test_the_cell_is_wired_through_the_two_doors():
    assert CFG["chain"] == "nv_tracking" and manifest.traffic(CELL)["loop"] == "tracking"
    assert CELL["chips"] == 1
    assert {m["name"] for m in manifest.end_to_end(BENCH, "tracking.loop")} == \
        {"frames_per_s", "setup_s"}
    layer = {m["name"] for m in manifest.per_layer(BENCH, "tracking.loop")}
    assert layer == set(READERS)
    for m in manifest.per_layer(BENCH, "tracking.loop"):
        assert m["workloads"] == ["tracking.loop"] and m["moves"] == "frames_per_s"
    for name in ("kernels_roofline", "device.idle_pct", "pipeline.host_us"):
        entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
        assert "tracking.loop" not in entry["workloads"]


def test_the_configuration_keeps_the_published_shapes():
    entry = next(c for c in BENCH["configs"] if c["name"] == "tracking_720p")
    assert entry["reduced"] == [] and CFG["reduced"] == [] and len(entry["source"]) <= 200
    assert (CFG["frame"]["height"], CFG["frame"]["width"], CFG["frame"]["format"]) == \
        (720, 1280, "NV21")
    t = CFG["template"]
    assert (t["height"], t["width"], t["channels"], t["low"], t["high"]) == (48, 48, 3, 180, 255)
    assert CFG["method"] == "TM_CCOEFF_NORMED"
    assert (CFG["crop"]["left"], CFG["crop"]["width"], CFG["crop"]["height"]) == (0, 1280, 320)
    assert (CFG["out"]["height"], CFG["out"]["width"]) == (224, 224)
    assert len(CFG["deployment_assumptions"]) == 3


def test_frames_tops_and_template_come_from_the_seed():
    _, cfg, _ = small_cell("tracking.loop")
    a = CHAIN.frames(cfg, 3, SEED, 0, "cpu")
    assert a.shape == (3, 90, 80) and a.dtype == torch.uint8
    assert torch.equal(a, CHAIN.frames(cfg, 3, SEED, 0, "cpu"))
    assert not torch.equal(a, CHAIN.frames(cfg, 3, SEED + 1, 0, "cpu"))
    tmpl = CHAIN.template(cfg, SEED, "cpu")
    assert tmpl.shape == (48, 48, 3) and int(tmpl.min()) >= 180
    for x, y in CHAIN.tops(cfg, 50, SEED, 0):
        assert 0 <= x <= 80 - 48 and 0 <= y <= 60 - 48


def test_decode_inverts_the_encoding_of_a_flat_colour():
    bgr = torch.empty((4, 6, 3), dtype=torch.uint8)
    bgr[...] = torch.tensor([30, 140, 220], dtype=torch.uint8)
    back = CHAIN.decode(CHAIN.encode_nv21(bgr))
    assert back.dtype == torch.float64 and back.shape == (4, 6, 3)
    assert (back - torch.tensor([30.0, 140.0, 220.0])).abs().max() <= 3


def test_the_reference_finds_the_planted_target_and_clamps_the_top():
    _, cfg, _ = small_cell("tracking.loop")
    tmpl = CHAIN.template(cfg, SEED, "cpu")
    for pos in [(0, 0), (32, 12), (17, 5)]:
        nv = CHAIN.make_frames(cfg, [pos], tmpl, SEED, 3, "cpu")[0]
        net_in, (x, y), score = CHAIN.reference(nv, tmpl, cfg)
        assert (x, y) == pos and 0.2 < float(score) <= 1
        assert net_in.shape == (1, 3, 16, 16) and net_in.dtype == torch.float64
        assert CHAIN.top_of(cfg, y) == min(max(y - 2, 0), 8)


@pytest.mark.parametrize("system,want", [("program", True), ("control", False)])
def test_a_short_run_of_the_loop_on_the_cpu(system, want):
    cell, cfg, traffic = small_cell("tracking.loop")
    r, numbers = run.execute(cell, cfg, traffic, SEED, 0.2, False, "cpu", system)
    ok, checks = check.verdict(numbers, check.limits(cfg, traffic), r.failed)
    assert ok is want, checks
    assert set(numbers) == {"pos_err_px", "score_err", "max_err_lsb", "off_share"}
    assert r.steps == r.attempted == r.completed >= 1 and r.samples
    assert all(key[1] is None and 0 <= key[0] < traffic["pool"] for key, _ in r.samples)
    if system == "program":
        assert numbers["pos_err_px"] == 0
        before, after = r.extra["counters"]["before"], r.extra["counters"]["after"]
        assert after["track.frames"] - before["track.frames"] == r.steps
        result = run.Result(r, cfg, traffic, "cpu", 1.0)
        assert manifest.reader("track.replay_share")(result) == 0.0  # no graph on the CPU


def test_the_frame_s_work_at_the_configuration_s_shapes():
    assert CHAIN.corr_flops(CFG) == 673 * 1233 * 48 * 48 * 3 * 2 == 11_471_279_616
    assert CHAIN.window_sum_bytes(CFG) == 24_336_144
    assert CHAIN.nv_bytes(CFG) == 614_400 + 602_112
    assert CHAIN.chain_bytes(CFG, 2) == 2 * (1_382_400 + 602_112 + 20)
    assert CHAIN.least_seconds(CFG, H100) == pytest.approx(171.21e-6, abs=0.01e-6)
    least = CHAIN.kernel_least_seconds(CFG, H100)
    assert least["sums"] == pytest.approx(7.26e-6, abs=0.01e-6)
    assert least["nv"] == pytest.approx(1_216_512 / 3.35e12)
    assert CHAIN.least_seconds(CFG, "some other card") is None


# A profiled sub-window of two frames, one graph launch each: every kernel of
# a graph carries its launch's correlation.  Epoch µs = base / 1e3 + ts.
BASE_NS = 1_000_000_000
SPANS = [("track.frame", 1_000_010.0, 1_000_040.0), ("track.frame", 1_000_500.0, 1_000_530.0)]
WINDOW = (1_000_000.0, 1_001_000.0)


def graph_frame(t0, corr):
    ev = [{"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": t0 + 20, "dur": 3,
           "args": {"correlation": corr}}]
    at = t0 + 30
    for name, dur in (("yuv2bgr_kernel", 4), ("void (anonymous namespace)::window_sum_kernel", 20),
                      ("void (anonymous namespace)::corr_kernel<3>(float const*)", 312),
                      ("void split_sum_kernel<float>", 4), ("elementwise", 60),
                      ("void (anonymous namespace)::nv_one_pass_kernel<true>", 10)):
        ev.append({"cat": "kernel", "name": name, "ts": at, "dur": dur,
                   "args": {"correlation": corr}})
        at += dur
    return ev


TRACE = {"baseTimeNanoseconds": BASE_NS,
         "traceEvents": graph_frame(0, 1) + graph_frame(490, 2)}


class Result:
    def __init__(self, r, summary):
        self.run, self.trace, self.cfg, self.kind = r, summary, CFG, H100
        self.traffic = {}


def test_the_seven_readers_on_a_hand_made_trace():
    timeline = trace.reduce(TRACE, SPANS, WINDOW)
    assert timeline["launched_in_spans"] == 12  # each graph's six kernels, through its launch
    assert timeline["kernels_s"]["track.frame"] == pytest.approx(2 * 410e-6)
    # 1002 frames in 1.0 s, 2 of them in a 0.001 s profiled section, 20 µs
    # of host a frame outside it
    summary = {"spans": {"track.frame": [1000, 0.02]}, "timeline": timeline,
               "section_s": 0.001}
    counters = {"before": {"track.frames": 16, "track.graph_replays": 15},
                "after": {"track.frames": 1018, "track.graph_replays": 1017}}
    result = Result(Run(steps=1002, elapsed_s=1.001, extra={"counters": counters}), summary)
    read = {name: manifest.reader(name)(result) for name in READERS}
    assert read["track.host_us"] == pytest.approx(20.0)
    assert read["track.replay_share"] == 1.0
    assert read["track.idle_pct"] == pytest.approx(100 * (1 - 410e-6 / 1e-3))
    assert read["track.roofline"] == pytest.approx(100 * 171.213e-6 / 410e-6, rel=1e-4)
    assert read["track.corr_roofline"] == pytest.approx(100 * 171.213e-6 / 316e-6, rel=1e-4)
    assert read["track.sums_roofline"] == pytest.approx(100 * 24_336_144 / 3.35e12 / 20e-6)
    assert read["track.nv_roofline"] == pytest.approx(100 * 1_216_512 / 3.35e12 / 10e-6)


def test_a_kernel_s_time_a_frame_counts_the_frames_the_card_ran():
    # The sub-window closes 100 µs into the second frame's correlation: the
    # card ran 1 + 124/410 frames there, and 312 + 4 + 100 µs of correlation.
    timeline = trace.reduce(TRACE, SPANS, (1_000_000.0, 1_000_644.0))
    assert timeline["busy_s"] == pytest.approx(534e-6)
    summary = {"spans": {}, "timeline": timeline, "section_s": 0.0}
    result = Result(Run(steps=2, elapsed_s=1.0), summary)
    ran = 534 / 410
    assert manifest.reader("track.corr_roofline")(result) == \
        pytest.approx(100 * 171.213e-6 * ran / 416e-6, rel=1e-4)


def test_the_readers_read_nothing_without_a_profile_or_counters():
    summary = {"spans": {}, "timeline": None, "section_s": 0.0}
    result = Result(Run(steps=10, elapsed_s=1.0), summary)
    for name in READERS:
        assert manifest.reader(name)(result) is None, name
