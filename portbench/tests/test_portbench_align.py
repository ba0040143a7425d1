"""The face-alignment deployment's files: the ``align_faces`` chain and the
``align`` loop kind on the CPU at a small size, the four readers of
``align.resident`` on a hand-made trace, the byte function, and the cell's
wiring in ``BENCHMARK.json`` (with ``cfg4.resident_b128``'s)."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import check, manifest, run, trace
from portbench.loops import Run
from portbench.tests.helpers import small_cell

BENCH = manifest.load()
CELL = manifest.cell(BENCH, "align.resident")
CFG = manifest.config(BENCH, CELL)
CHAIN = manifest.chain(CFG)
H100 = "NVIDIA H100 80GB HBM3"
SEED = 2**31 + 221
READERS = ["align.host_us", "align.idle_pct", "align.roofline", "align.launch_share"]


def test_the_cells_are_wired_through_the_two_doors():
    assert CFG["chain"] == "align_faces" and manifest.traffic(CELL)["loop"] == "align"
    assert CELL["chips"] == 1
    assert {m["name"] for m in manifest.end_to_end(BENCH, "align.resident")} == \
        {"frames_per_s", "setup_s"}
    assert {m["name"] for m in manifest.per_layer(BENCH, "align.resident")} == set(READERS)
    b128 = manifest.cell(BENCH, "cfg4.resident_b128")
    assert b128["config"] == "cfg4_fused_1080p" and b128["chips"] == 1
    traffic = manifest.traffic(b128)
    assert (traffic["loop"], traffic["batch"], traffic["pool"]) == ("resident", 128, 4)
    assert {m["name"] for m in manifest.per_layer(BENCH, "cfg4.resident_b128")} == \
        {"pipeline.host_us", "kernels_roofline", "device.idle_pct"}


def test_the_configuration_keeps_the_published_shapes():
    entry = next(c for c in BENCH["configs"] if c["name"] == "align_faces_1080p")
    assert entry["reduced"] == [] and CFG["reduced"] == [] and len(entry["source"]) <= 200
    assert (CFG["frame"]["height"], CFG["frame"]["width"], CFG["frame"]["channels"]) == \
        (1080, 1920, 3)
    assert (CFG["out"]["height"], CFG["out"]["width"]) == (112, 112)
    assert CFG["mean"] == CFG["stddev"] == [127.5] * 3 and CFG["to_rgb"] is True
    assert CFG["assumed"] == [] and len(CFG["deployment_assumptions"]) == 8
    assert set(CFG["limits"]) == set(CFG["limits_why"])


def test_face_tables_come_from_the_seed():
    a = CHAIN.tops(CFG, 16, SEED, 3)
    b = CHAIN.tops(CFG, 16, SEED, 3)
    c = CHAIN.tops(CFG, 16, SEED + 1, 3)
    for x, y in ((a.index, b.index), (a.matrices, b.matrices), (a.sides, b.sides)):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.sides[:10], c.sides[:10])
    bulk = CHAIN.face_tables(CFG, 16, 64, SEED, 3, faces=1000)
    again = CHAIN.face_tables(CFG, 16, 64, SEED, 3, faces=1000)
    assert all(np.array_equal(bulk[t].matrices, again[t].matrices) for t in range(64))
    bulk = [bulk[t] for t in range(64)]
    f = CFG["faces"]
    for t in (a, c, *bulk):
        assert t.index.dtype == np.int32 and t.matrices.dtype == np.float32
        assert t.matrices.shape == (len(t.index), 2, 3) and t.sides.shape == t.index.shape
        per = np.bincount(t.index, minlength=16)
        assert per.min() >= f["per_frame_min"] and per.max() <= f["per_frame_max"]
        assert np.all(np.diff(t.index) >= 0) and t.index.max() < 16
        assert t.sides.min() >= 40 and t.sides.max() <= 400


def test_face_counts_are_drawn_frame_by_frame():
    """Each frame's count from the clipped geometric of mean 12, so a batch
    of 16 holds ~192 +- 46 faces, alike for eight tables in a row and drawn
    anew for the next eight; sides, rolls and centres drawn independently
    over their ranges, into a pool the tables take in turn."""
    pool = CHAIN.face_tables(CFG, 16, 8192 * 8, SEED, 0, faces=100_000)
    k = np.array([n for _, _, n in pool.spans])
    runs = k[::8]
    assert np.all(k.reshape(-1, 8) == runs[:, None])
    assert 188 < runs.mean() < 195 and 40 < runs.std() < 52 and len(set(runs.tolist())) > 100
    counts = [np.bincount(pool[t].index, minlength=16) for t in range(16)]
    assert all(np.array_equal(counts[t], counts[0]) for t in range(8))
    assert not np.array_equal(counts[7], counts[8])
    assert pool.sides.shape == (100_000 + k.max(),)
    u = np.log(pool.sides[:100_000] / 40) / np.log(10)  # uniform on [0, 1)
    assert abs(u.mean() - 0.5) < 0.01 and abs(u.std() - 12 ** -0.5) < 0.01
    m = pool.matrices[:100_000].astype(np.float64)
    roll = np.degrees(np.arctan2(m[:, 0, 1], m[:, 0, 0]))
    assert abs(roll.mean()) < 0.5 and abs(roll.std() - 30 / 3 ** 0.5) < 0.5
    # each table takes the faces after its predecessor's, round the pool
    starts = np.cumsum(k) - k
    assert [o for _, o, _ in pool.spans] == (starts % 100_000).tolist()
    wraps = next(t for t in range(len(k)) if starts[t] % 100_000 + k[t] > 100_000)
    o = starts[wraps] % 100_000
    assert np.array_equal(pool[wraps].sides, np.concatenate(
        [pool.sides[o:100_000], pool.sides[:o + k[wraps] - 100_000]]))


def test_tables_go_to_the_device_as_views_of_one_copy():
    pool = CHAIN.face_tables(CFG, 4, 400, SEED, 0, faces=500)
    rois = CHAIN.tables_on_device(pool, "cpu")
    assert len(rois) == 400
    for t, (index, matrices) in enumerate(rois):
        assert index.is_contiguous() and matrices.is_contiguous()
        assert np.array_equal(index.numpy(), pool[t].index)
        assert np.array_equal(matrices.numpy(), pool[t].matrices)
    assert rois[1][0].untyped_storage().data_ptr() == rois[0][0].untyped_storage().data_ptr()
    assert rois[-1][1].untyped_storage().data_ptr() == rois[0][1].untyped_storage().data_ptr()


def test_a_matrix_maps_its_face_centre_to_the_output_centre():
    t = CHAIN.tops(CFG, 4, SEED, 0)
    m = t.matrices.astype(np.float64)
    inv = CHAIN.inverse(t.matrices).reshape(-1, 2, 3).astype(np.float64)
    centre = inv[:, :, :2] @ np.array([56.0, 56.0]) + inv[:, :, 2]  # source point of (56, 56)
    back = np.einsum("kij,kj->ki", m[:, :, :2], centre) + m[:, :, 2]
    assert np.allclose(back, 56.0, atol=1e-3)
    scale = np.hypot(m[:, 0, 0], m[:, 0, 1])
    assert np.allclose(scale * t.sides, 112, rtol=1e-6)
    roll = np.degrees(np.arctan2(m[:, 0, 1], m[:, 0, 0]))
    assert np.abs(roll).max() <= 30 + 1e-4


@pytest.mark.parametrize("system,want", [("program", True), ("control", False)])
def test_a_short_run_of_the_loop_on_the_cpu(system, want):
    cell, cfg, traffic = small_cell("align.resident")
    r, numbers = run.execute(cell, cfg, traffic, SEED, 0.2, False, "cpu", system)
    ok, checks = check.verdict(numbers, check.limits(cfg, traffic), r.failed)
    assert ok is want, checks
    assert set(numbers) == {"max_err_lsb", "off_share"}
    assert r.attempted == r.completed == r.steps * traffic["batch"] and r.samples
    assert all(key[1] is None and 0 <= key[0] < traffic["tables"] for key, _ in r.samples)
    assert len(r.pool) == traffic["tables"] and r.pool[5][0] is r.pool[5 % traffic["pool"]][0]
    if system == "program":
        before, after = r.extra["counters"]["before"], r.extra["counters"]["after"]
        assert after["align.batches"] - before["align.batches"] == r.steps
        assert after["align_faces_torch"] - before["align_faces_torch"] == r.steps
        tables = r.extra["tables"]
        faces = sum(len(tables[(i + 1) % len(tables)].index) for i in range(r.steps))
        assert after["align.rois"] - before["align.rois"] == faces
        result = run.Result(r, cfg, traffic, "cpu", 1.0)
        assert manifest.reader("align.launch_share")(result) == 0.0  # no kernel on the CPU


def test_the_reference_agrees_with_the_program_and_fails_a_perturbed_output():
    _, cfg, _ = small_cell("align.resident")
    frames = CHAIN.frames(cfg, 3, SEED, 0, "cpu")
    top = CHAIN.on_device(CHAIN.tops(cfg, 3, SEED, 0), "cpu")
    program = CHAIN.system("program", cfg, "cpu")
    out = program.batch(frames, top)
    pool = [(frames, *top)]
    numbers = CHAIN.compare([((0, None), out)], pool, cfg, "cpu")
    assert numbers["max_err_lsb"] <= 1 + 1e-3 and numbers["off_share"] <= 1e-3
    ref = CHAIN.reference(frames, cfg, top)
    assert ref.dtype == torch.float64 and ref.shape == out.shape
    steps = cfg["limits"]["max_err_lsb"] + 2
    bad = out.clone()
    bad[1, 2, 3, 4] += steps / 127.5  # past the limit on one value
    worse = CHAIN.compare([((0, None), bad)], pool, cfg, "cpu")
    assert worse["max_err_lsb"] >= steps - 0.01 and not check.verdict(worse, cfg["limits"], 0)[0]
    swapped = CHAIN.compare([((0, None), out.flip(1))], pool, cfg, "cpu")
    assert not check.verdict(swapped, cfg["limits"], 0)[0]


def test_the_byte_function():
    hw = 112 * 112
    assert list(CHAIN.face_bytes(CFG, [40, 224, 400])) == \
        [3 * hw * 4 + 3 * 1600, 3 * hw * 4 + 3 * 4 * hw, 3 * hw * 4 + 3 * 4 * hw]
    t = CHAIN.tops(CFG, 16, SEED, 0)
    assert CHAIN.table_bytes(CFG, t) == pytest.approx(CHAIN.face_bytes(CFG, t.sides).sum())
    # the mean over the log-uniform side, against the strata of 200,000 faces
    sides = 40 * 10 ** ((np.arange(200_000) + 0.5) / 200_000)
    mean = CHAIN.face_bytes(CFG, sides).mean()
    assert CHAIN.chain_bytes(CFG, 16) == pytest.approx(16 * 12 * mean, rel=1e-6)
    # ~28.9 MB of output and ~13.4 MB of source a batch: ~12.6 us at 3.35 TB/s
    assert CHAIN.chain_bytes(CFG, 16) / 3.35e12 == pytest.approx(12.6e-6, rel=0.01)


# A profiled sub-window of two batches, one kernel launch each.
BASE_NS = 1_000_000_000
SPANS = [("align.batch", 1_000_010.0, 1_000_030.0), ("align.batch", 1_000_100.0, 1_000_120.0)]
WINDOW = (1_000_000.0, 1_000_200.0)


def launch(t0, corr, dur):
    return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t0, "dur": 3,
             "args": {"correlation": corr}},
            {"cat": "kernel", "name": "void (anonymous namespace)::align_kernel(AlignParams)",
             "ts": t0 + 30, "dur": dur, "args": {"correlation": corr}}]


TRACE = {"baseTimeNanoseconds": BASE_NS, "traceEvents": launch(15, 1, 40) + launch(105, 2, 40)}


class Result:
    def __init__(self, r, summary):
        self.run, self.trace, self.cfg, self.kind = r, summary, CFG, H100
        self.traffic = {}


def test_the_four_readers_on_a_hand_made_trace():
    timeline = trace.reduce(TRACE, SPANS, WINDOW)
    assert timeline["kernels_s"]["align.batch"] == pytest.approx(80e-6)
    tables = [CHAIN.tops(CFG, 16, SEED, k) for k in range(2)]
    # 1002 batches in 0.1 s, 2 of them in a 0.0002 s profiled section, 25 µs
    # of host a batch outside it
    summary = {"spans": {"align.batch": [1000, 0.025]}, "timeline": timeline,
               "section_s": 0.0002}
    counters = {"before": {"align.batches": 16, "align_faces": 16},
                "after": {"align.batches": 1018, "align_faces": 1018}}
    extra = {"counters": counters, "tables": tables, "profiled": [1, 1]}
    result = Result(Run(steps=1002, elapsed_s=0.1002, extra=extra), summary)
    read = {name: manifest.reader(name)(result) for name in READERS}
    assert read["align.host_us"] == pytest.approx(25.0)
    assert read["align.launch_share"] == 1.0
    assert read["align.idle_pct"] == pytest.approx(100 * (1 - 40e-6 / 100e-6))
    least = (CHAIN.table_bytes(CFG, tables[0]) + CHAIN.table_bytes(CFG, tables[1])) / 2 / 3.35e12
    assert read["align.roofline"] == pytest.approx(100 * least / 40e-6, rel=1e-6)
    assert 20 < read["align.roofline"] < 40


def test_the_readers_read_nothing_without_a_profile_or_counters():
    summary = {"spans": {}, "timeline": None, "section_s": 0.0}
    result = Result(Run(steps=10, elapsed_s=1.0), summary)
    for name in READERS:
        assert manifest.reader(name)(result) is None, name
    assert math.isfinite(CHAIN.chain_bytes(CFG, 1))
