"""``models.Tracker`` on seeded NV21 frames, against the plain float64
reference of the benchmark's tracking chain
(``portbench/chains/nv_tracking.py``).

On the CPU at a small size: 144x176 NV21 frames, a 12x12 BGR template, a
176x64 window, 32x32 out, targets placed so that the window's top clamps
to 0, to h - roi_h and neither.  The found position must equal the
reference's; the score and the network input are held to tolerances
stated with their reasons below.  A tracker that matches with
TM_CCORR_NORMED, or puts the window one row off, must fail the same
comparison.  On the card (``-m gpu``): every replay of the tracker's graph
equals the eager step on the same frame bit for bit, a step's outputs
survive the ``SLOTS - 1`` steps after it, and the counters say ``SLOTS``
graphs and one replay a frame after the first.
"""
import copy

import numpy as np
import pytest
import torch

from portbench import check, manifest
from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import MatchMode
from vacv_tpu_torch.models import Tracker
from vacv_tpu_torch.ops.match_template import match_template, min_max_loc
from vacv_tpu_torch.ops.cvt_color import cvt_color
from vacv_tpu_torch.core.types import ColorCode
from vacv_tpu_torch.utils import trace

CHAIN = manifest.module("chains", "nv_tracking")
H, W, TH, ROI_H, OUT = 144, 176, 12, 64, 32
SEED = 2**31 + 4321
# (x, y) of the target: the window's top clamp(y - 26, 0, 80) clamps to 0,
# is odd, is even, and clamps to 80.
POSITIONS = [(5, 3), (81, 61), (100, 90), (164, 132)]
# The score: f32 window sums of up to 12 * 12 * 3 * 255^2 (past 2^24) lose
# their last bits, and the window's variance subtracts two of them; 1e-4 is
# well below the 0.01-0.5 that another mode or window gives.
SCORE_TOL = 1e-4
# The network input: at this geometry (64 -> 32 rows, 176 -> 32 columns)
# the Q11 taps sum exactly in f32, so only the normalize's f32 rounding is
# left, ~1e-5 of a u8 step.
LSB_TOL = 1e-3


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


def small_cfg():
    cfg = copy.deepcopy(manifest.config(manifest.load(), {"config": "tracking_720p"}))
    cfg["frame"].update(height=H, width=W)
    cfg["template"].update(height=TH, width=TH)
    cfg["crop"].update(left=0, width=W, height=ROI_H)
    cfg["out"].update(height=OUT, width=OUT)
    return cfg


def inputs(cfg, positions, device="cpu", seed=SEED):
    tmpl = CHAIN.template(cfg, seed, device)
    return CHAIN.make_frames(cfg, positions, tmpl, seed, 0, device), tmpl


def tracker_of(cfg, tmpl, cls=Tracker, device="cpu"):
    c, out = cfg["crop"], cfg["out"]
    return cls(tmpl, frame_hw=(cfg["frame"]["height"], cfg["frame"]["width"]),
               roi_h=c["height"], out_size=(out["width"], out["height"]), device=device,
               roi_left=c["left"], roi_w=c["width"])


def numbers(cfg, tracker, frames, tmpl, device="cpu"):
    samples = [((j, None), tracker.step(f)) for j, f in enumerate(frames)]
    return CHAIN.compare(samples, {"frames": frames, "template": tmpl}, cfg, device)


def within(n):
    return (n["pos_err_px"] == 0 and n["score_err"] <= SCORE_TOL
            and n["max_err_lsb"] <= LSB_TOL and n["off_share"] == 0)


@pytest.mark.parametrize("seed", [SEED, 7, 2**33 + 1])
def test_the_tracker_agrees_with_the_reference(seed):
    cfg = small_cfg()
    frames, tmpl = inputs(cfg, POSITIONS, seed=seed)
    n = numbers(cfg, tracker_of(cfg, tmpl), frames, tmpl)
    assert within(n), n


@pytest.mark.parametrize("pos", POSITIONS)
def test_each_top_rule_case_finds_the_planted_target(pos):
    cfg = small_cfg()
    frames, tmpl = inputs(cfg, [pos])
    net_in, (x, y), score = tracker_of(cfg, tmpl).step(frames[0])
    assert (int(x), int(y)) == pos
    ref, (rx, ry), rscore = CHAIN.reference(frames[0], tmpl, cfg)
    assert (rx, ry) == pos and abs(float(score) - float(rscore)) <= SCORE_TOL
    assert CHAIN.top_of(cfg, pos[1]) == min(max(pos[1] - 26, 0), H - ROI_H)
    tally = check.Tally()
    _, _, _, std = CHAIN._reference(frames[0], tmpl, cfg)
    tally.add(net_in, ref, std)
    assert tally.numbers()["max_err_lsb"] <= LSB_TOL


class CcorrTracker(Tracker):
    """A fault: TM_CCORR_NORMED in place of TM_CCOEFF_NORMED."""

    def _track(self, nv):
        bgr = cvt_color(nv, ColorCode.COLOR_YUV2BGR_NV21)
        resp = match_template(bgr, self.template, MatchMode.TM_CCORR_NORMED)
        _, score, _, (x, y) = min_max_loc(resp)
        return self.pre.batch(nv[None], top=self.top_of(y)), (x, y), score


class OffByOneTracker(Tracker):
    """A fault: the window one row below where the rule puts it."""

    def top_of(self, y):
        return super().top_of(y) + 1


@pytest.mark.parametrize("cls", [CcorrTracker, OffByOneTracker])
def test_a_faulty_tracker_fails_the_comparison(cls):
    cfg = small_cfg()
    frames, tmpl = inputs(cfg, POSITIONS[1:3])  # tops 35 and 64: a row lower stays inside
    n = numbers(cfg, tracker_of(cfg, tmpl, cls), frames, tmpl)
    assert not within(n), n
    assert not check.verdict(n, cfg["limits"], 0)[0], n


def test_outputs_are_tensors_and_the_cpu_runs_eagerly():
    cfg = small_cfg()
    frames, tmpl = inputs(cfg, POSITIONS[:2])
    tracker = tracker_of(cfg, tmpl)
    before = {k: trace.counter(k) for k in ("track.frames", "track.graph_replays",
                                            "preprocess_fused_nv_torch", "match_corr_torch")}
    net_in, (x, y), score = tracker.step(frames[0].numpy())  # a numpy frame goes to the CPU
    tracker.step(frames[1])
    assert net_in.shape == (1, 3, OUT, OUT) and net_in.dtype == torch.float32
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0 for v in (x, y, score))
    after = {k: trace.counter(k) - before[k] for k in before}
    assert after == {"track.frames": 2, "track.graph_replays": 0,
                     "preprocess_fused_nv_torch": 2, "match_corr_torch": 2}


def test_the_torch_backend_finds_the_same():
    cfg = small_cfg()
    frames, tmpl = inputs(cfg, POSITIONS)
    tracker = tracker_of(cfg, tmpl)
    want = [tracker.step(f) for f in frames]
    with config.backend("torch"):
        got = [tracker.step(f) for f in frames]
    for (n1, (x1, y1), s1), (n2, (x2, y2), s2) in zip(want, got):
        assert (int(x1), int(y1)) == (int(x2), int(y2))
        assert abs(float(s1) - float(s2)) <= SCORE_TOL
        np.testing.assert_allclose(n1.numpy(), n2.numpy(), atol=1e-4)


def test_the_tracker_rejects_what_it_cannot_track():
    cfg = small_cfg()
    frames, tmpl = inputs(cfg, POSITIONS[:1])
    tracker = tracker_of(cfg, tmpl)
    with pytest.raises(ValueError, match="u8 NV21"):
        tracker.step(frames[0][:-2])
    with pytest.raises(ValueError, match="template"):
        Tracker(tmpl[..., 0], frame_hw=(H, W), roi_h=ROI_H, device="cpu")
    with pytest.raises(ValueError, match="window"):
        Tracker(tmpl, frame_hw=(H, W), roi_h=H + 2, device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_graph_replays_equal_the_eager_step_and_survive(cuda):
    cfg = manifest.config(manifest.load(), {"config": "tracking_720p"})
    frames = CHAIN.frames(cfg, 6, SEED, 0, cuda)
    tmpl = CHAIN.template(cfg, SEED, cuda)
    truths = CHAIN.tops(cfg, 6, SEED, 0)
    tracker = tracker_of(cfg, tmpl, device=cuda)
    names = ("track.frames", "track.graph_replays", "track.graphs_made", "match_corr",
             "window_sum", "yuv2bgr", "preprocess_fused_nv")
    before = {k: trace.counter(k) for k in names}
    outs = [tracker.step(f) for f in frames]
    torch.cuda.synchronize()
    counted = {k: trace.counter(k) - before[k] for k in names}
    # the first step eager, then SLOTS captures; five replays, which launch no wrapper
    captured = 1 + Tracker.SLOTS
    assert counted == {"track.frames": 6, "track.graph_replays": 5,
                       "track.graphs_made": Tracker.SLOTS, "match_corr": captured,
                       "window_sum": captured, "yuv2bgr": captured,
                       "preprocess_fused_nv": captured}
    # the last SLOTS steps' outputs are the graphs' own, and all still there
    last = list(zip(frames, truths, outs))[-Tracker.SLOTS:]
    for f, (x0, y0), (net, (x, y), score) in last:
        e_net, (ex, ey), e_score = tracker._track(f)
        assert torch.equal(net, e_net) and torch.equal(score, e_score)
        assert (int(x), int(y)) == (int(ex), int(ey))
        assert abs(int(x) - x0) <= 2 and abs(int(y) - y0) <= 2
    samples = [((j, None), o) for j, o in enumerate(outs)][-Tracker.SLOTS:]
    n = CHAIN.compare(samples, {"frames": frames, "template": tmpl}, cfg, cuda)
    assert check.verdict(n, cfg["limits"], 0)[0], n
