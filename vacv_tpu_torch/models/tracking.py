"""Camera tracking: one NV21 frame in, the network's input centred on a
template out.

``Tracker.step`` does, for each (h·3/2, w) u8 NV21 frame, the steps of
``examples/camera_tracking.py``: decode to BGR (``cvt_color``, the yuv2bgr
kernel), search the whole frame for the template with
``match_template(..., TM_CCOEFF_NORMED)`` (the correlation kernel and the
window sums), take the best position with ``min_max_loc``, centre a
``roi_h``-row window on it, clamped to the frame, as a device tensor, and
preprocess that window with ``Preprocessor.batch`` on the fused NV route
(decode → crop → bilinear → CHW f32 → self-statistics normalize in one
kernel).  Nothing is read back and nothing waits for the card.

On a CUDA device under the ``auto`` backend the first step runs eagerly
on the tracker's own stream, which makes every build, table and launch
record the step needs there; the tracker then captures the step ``SLOTS``
times into ``torch.cuda.CUDAGraph``s on that stream, one input frame for
all, each capture with a memory pool and outputs of its own.  Each later
step copies the caller's frame into that input and replays the next graph
in turn: two operations on the stream a frame.  A step's outputs are that
graph's memory, so the next ``SLOTS - 1`` steps leave them alone and the
one after overwrites them; a caller that keeps outputs longer clones them.
(Cloning the outputs after each replay would put three more copies on the
stream a frame: with them an H100's pace was 483 µs a frame at best,
without them 477.5–478.1.)  The
route counters (``config.record_kernel``) count the eager step and each
capture, and no replay.  On the CPU, or under the ``torch`` backend, every
step runs eagerly and returns new tensors.

Tracer (``utils/trace.py``): spans ``track.step`` and ``track.capture``;
counters ``track.frames`` (every step), ``track.graph_replays`` and
``track.graphs_made``.
"""
from __future__ import annotations

import torch

from .. import config
from ..core.image import as_tensor
from ..core.types import ColorCode, MatchMode, VRect
from ..ops.cvt_color import cvt_color
from ..ops.match_template import match_template, min_max_loc
from ..utils import trace
from .pipeline import PreprocessConfig, Preprocessor


class _Ring:
    """The captured step: one input frame, the graphs and each graph's
    outputs (net input, (x, y), score), replayed in turn."""

    __slots__ = ("frame", "graphs", "outs", "turn")

    def __init__(self, frame, graphs, outs):
        self.frame, self.graphs, self.outs, self.turn = frame, graphs, outs, 0

    def replay(self, nv):
        self.frame.copy_(nv)
        k = self.turn
        self.turn = (k + 1) % len(self.graphs)
        self.graphs[k].replay()
        trace.count("track.graph_replays")
        return self.outs[k]


class Tracker:
    """Finds ``template`` ((th, tw, 3) u8 BGR) in every (h·3/2, w) u8 NV21
    frame of ``frame_hw = (h, w)`` and turns the ``roi_h``-row window
    centred on it into the network input of ``out_size`` (w, h).

    The window spans columns ``roi_left`` to ``roi_left + roi_w`` (the
    whole width by default); its top is ``clamp(y - (roi_h - th) // 2, 0,
    h - roi_h)`` for the match at (x, y).  ``device`` holds the template
    and takes the frames (by default ``config.default_device()``)."""

    SLOTS = 4  # graphs replayed in turn; a step's outputs outlive the next SLOTS - 1 steps

    def __init__(self, template, frame_hw=(720, 1280), roi_h=320, out_size=(224, 224),
                 device=None, *, roi_left=0, roi_w=None):
        self.device = torch.device(device if device is not None else config.default_device())
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.template = as_tensor(template, self.device).to(self.device)
        h, w = (int(v) for v in frame_hw)
        roi_w = w - roi_left if roi_w is None else int(roi_w)
        if self.template.ndim != 3 or self.template.shape[2] != 3 \
                or self.template.dtype != torch.uint8:
            raise ValueError(f"the template must be (th, tw, 3) u8 BGR, got "
                             f"{tuple(self.template.shape)} {self.template.dtype}")
        th, tw = self.template.shape[:2]
        if h % 2 or w % 2 or not (th <= h and tw <= w):
            raise ValueError(f"a {th}x{tw} template in {h}x{w} NV21 frames (even sides)")
        if not (0 < roi_h <= h and 0 <= roi_left and 0 < roi_w and roi_left + roi_w <= w):
            raise ValueError(f"window of {roi_w}x{roi_h} at column {roi_left} outside {h}x{w}")
        self.frame_hw, self.roi_h = (h, w), int(roi_h)
        self.shape = (h * 3 // 2, w)
        self.pre = Preprocessor(PreprocessConfig(
            color_code=ColorCode.COLOR_YUV2BGR_NV21,
            crop_rect=VRect(roi_left, 0, roi_left + roi_w, self.roi_h),
            out_size=tuple(int(v) for v in out_size)), device=self.device)
        self._stream = None
        self._ring = None

    def top_of(self, y: torch.Tensor) -> torch.Tensor:
        """The window's top for a match at row ``y`` (a tensor): centred on
        the template, clamped to the frame."""
        h, th = self.frame_hw[0], self.template.shape[0]
        return torch.clamp(y - (self.roi_h - th) // 2, 0, h - self.roi_h)

    def _track(self, nv):
        """The step's ops, eagerly: (net input (1, 3, oh, ow) f32, (x, y),
        score), all 0-d device tensors but the first."""
        bgr = cvt_color(nv, ColorCode.COLOR_YUV2BGR_NV21)
        resp = match_template(bgr, self.template, MatchMode.TM_CCOEFF_NORMED)
        _, score, _, (x, y) = min_max_loc(resp)
        return self.pre.batch(nv[None], top=self.top_of(y)), (x, y), score

    def _capture(self, nv):
        """The first step on the card: run it eagerly on the tracker's stream
        (the warm-up that makes the step's tables and launch records for
        that stream), then capture it there ``SLOTS`` times.  Returns the
        eager outputs."""
        span = trace.begin("track.capture") if trace.ON else None
        try:
            caller = torch.cuda.current_stream(self.device)
            stream = self._stream = torch.cuda.Stream(self.device)
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                frame = torch.empty_like(nv, memory_format=torch.contiguous_format)
                frame.copy_(nv)
                net_in, (x, y), score = self._track(frame)
                graphs, outs = [], []
                for _ in range(self.SLOTS):
                    graph = torch.cuda.CUDAGraph()
                    # a pool of its own: in a shared one, a later capture may put its
                    # outputs where an earlier graph keeps a temporary, and that
                    # graph's next replay would overwrite them
                    with torch.cuda.graph(graph, stream=stream):
                        outs.append(self._track(frame))
                    graphs.append(graph)
                    trace.count("track.graphs_made")
            caller.wait_stream(stream)
            for t in (net_in, x, y, score):
                t.record_stream(caller)
            self._ring = _Ring(frame, graphs, outs)
            return net_in, (x, y), score
        finally:
            if span is not None:
                trace.end(span)

    def step(self, nv):
        """Track one (h·3/2, w) u8 NV21 frame on the tracker's device:
        ``(net_in (1, 3, oh, ow) f32, (x, y), score)``, device tensors that
        the next ``SLOTS - 1`` steps leave alone (module docstring).  Traced
        as span ``track.step``."""
        span = trace.begin("track.step") if trace.ON else None
        try:
            nv = as_tensor(nv, self.device)
            if tuple(nv.shape) != self.shape or nv.dtype != torch.uint8:
                raise ValueError(f"frames must be {self.shape} u8 NV21, got "
                                 f"{tuple(nv.shape)} {nv.dtype}")
            if nv.device != self.device:
                raise ValueError(f"the frame lies on {nv.device}, the tracker on {self.device}")
            trace.count("track.frames")
            if not (nv.is_cuda and config.use_fused()):
                return self._track(nv)
            if self._ring is None:
                return self._capture(nv)
            return self._ring.replay(nv)
        finally:
            if span is not None:
                trace.end(span)
