"""Face alignment: every detected face of a batch of frames turned into a
recognition network's input in one call.

``Aligner.batch(frames, index, matrices)`` takes (N, H, W, 3) u8 BGR frames
and a table of K faces, each a frame index and the forward 2 x 3 similarity
matrix that a landmark fit gives (``index`` (K,) int32, ``matrices`` (K, 2,
3) float32, on the frames' device), and returns (K, 3, h, w) float32: each
face warped to ``dsize`` (bilinear, constant border 0) and normalized with
static statistics, the planes in RGB order with ``to_rgb``
(``ops/fused.py::warp_affine_normalize_batch``).  The defaults are
ArcFace's input as InsightFace feeds it (``face_align.norm_crop``): 112 x
112, ``(x - 127.5) / 127.5`` (here with vacv's ``+ 1e-6``), RGB.

On a CUDA batch under the ``auto`` backend a batch is one launch of the
alignment kernel (``ops/cuda/align.py``).  The Aligner keeps that launch's
record for each batch signature (the frames' shape, strides, type and
device, the current stream), at most ``_RECORDS`` of them, the oldest
dropped first, as ``Preprocessor`` keeps its records: a later batch of the
signature only runs the record, whatever its face count K (the record
checks the table and hands K to the launch).  Its host work does not grow
with K, and nothing is read back or waited for.  Elsewhere a batch runs
``warp_affine_normalize_batch`` (the plain version on CPU tensors).

Tracer (``utils/trace.py``): span ``align.batch``; counters
``align.batches``, ``align.rois`` (faces), the route counter
``align_faces`` (launches; ``align_faces_torch`` on the CPU) and
``align.records_made`` / ``align.record_hits``.
"""
from __future__ import annotations

import torch

from .. import config
from ..core.device_tables import stream_key
from ..core.image import as_tensor
from ..ops.cuda.align import prepare_align_faces
from ..ops.fused import warp_affine_normalize_batch
from ..utils import trace

_RECORDS = 16  # launch records an Aligner keeps; the oldest goes first
ARCFACE_MEAN = ARCFACE_STD = (127.5, 127.5, 127.5)


def _signature(frames) -> tuple:
    """What an alignment batch's launch record is made from, beside the
    Aligner's own settings: the frames and the stream, not the face table."""
    return (frames.shape, frames.stride(), frames.dtype, frames.get_device(),
            stream_key(frames.device))


class Aligner:
    """Warps every face of a batch of frames to ``dsize`` (w, h) and
    normalizes it with ``mean`` and ``stddev`` (per output plane, or one
    value for all), planes in RGB order with ``to_rgb``.  ``device`` takes
    numpy frames (by default ``config.default_device()``)."""

    def __init__(self, dsize=(112, 112), mean=ARCFACE_MEAN, stddev=ARCFACE_STD, to_rgb=True,
                 device=None):
        w, h = (int(v) for v in dsize)
        if w <= 0 or h <= 0:
            raise ValueError(f"dsize must be positive (w, h), got {tuple(dsize)}")
        if mean is None or stddev is None:
            raise ValueError("the Aligner normalizes with static statistics: give mean and stddev")
        self.dsize, self.mean, self.stddev, self.to_rgb = (w, h), mean, stddev, bool(to_rgb)
        self.device = torch.device(device if device is not None else config.default_device())
        self._records: dict = {}

    def route(self, device=None) -> str:
        """The route a batch on ``device`` (by default the Aligner's) takes:
        ``"align_faces"`` (the kernel) on a CUDA device under the ``auto``
        backend, ``"align_faces_torch"`` (the plain version) otherwise."""
        dev = torch.device(device) if device is not None else self.device
        return "align_faces" if dev.type == "cuda" and config.use_fused() else "align_faces_torch"

    def _record(self, frames, index, matrices):
        """The launch record of this batch's signature, made on its first
        batch (``align.records_made``), a hit after (``align.record_hits``)."""
        key = _signature(frames)
        rec = self._records.get(key)
        if rec is None:
            rec = prepare_align_faces(frames, index, matrices, self.dsize, self.mean, self.stddev,
                                      self.to_rgb)
            if len(self._records) >= _RECORDS:
                del self._records[next(iter(self._records))]
            self._records[key] = rec
            trace.count("align.records_made")
        else:
            trace.count("align.record_hits")
        return rec

    def batch(self, frames, index, matrices):
        """(K, 3, h, w) float32, face k from frame ``index[k]`` by
        ``matrices[k]`` (module docstring).  Traced as span
        ``align.batch``."""
        span = trace.begin("align.batch") if trace.ON else None
        try:
            frames = as_tensor(frames, self.device)
            index = as_tensor(index, frames.device)
            matrices = as_tensor(matrices, frames.device)
            trace.count("align.batches")
            trace.count("align.rois", index.shape[0])
            if frames.is_cuda and config.use_fused():
                return self._record(frames, index, matrices).run(frames, index, matrices)
            return warp_affine_normalize_batch(frames, index, matrices, self.dsize, self.mean,
                                               self.stddev, self.to_rgb)
        finally:
            if span is not None:
                trace.end(span)
