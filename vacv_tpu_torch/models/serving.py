"""Streamed (per-frame) serving with bounded in-flight depth.

The counterpart of ``vacv_tpu/models/serving.py``: results in submission
order, at most ``depth`` frames in flight, ``submit`` hands back the
oldest result once ``depth`` are pending and ``drain`` yields the rest.

JAX gets the overlap of successive frames from its asynchronous
dispatch.  Here it comes from CUDA streams: frame k runs on stream
``k % depth`` (the kernel wrappers launch on the current stream), and a
numpy frame reaches the card through a ring of ``depth`` pinned host
buffers with ``non_blocking`` copies, so the host copies frame k+1 while
the card still works on frame k.  A slot is refilled only after the copy
out of it has completed.  Before a result is handed over, the consumer's
current stream waits on that frame's event and the result's memory is
recorded as used by that stream; a readback then blocks on that frame
alone.  A tensor already on the card is read on its lane's stream after
the work the caller queued before ``submit``.

First-use device tables (the resize taps and weights) are copied from
pageable memory by a blocking copy, so they are whole on the card before
any stream reads them.  On the CPU the same code runs without streams.

Traced (``utils/trace.py``), each frame carries its number: span
``serve.submit`` around ``submit``; inside a host frame's upload
``serve.slot_wait`` (the wait for the slot's previous copy),
``serve.stage`` (the copy into the pinned slot) and ``serve.h2d`` (the
copy's enqueue and its event); ``serve.hand_over`` around handing a result
over.  Counter: ``serve.h2d_bytes`` sent to the card.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from .. import config
from ..core.image import as_tensor
from ..utils import trace


def _record(out, stream) -> None:
    """Mark every CUDA tensor of a result as used by ``stream``."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            out.record_stream(stream)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _record(o, stream)


class _Lane:
    """One CUDA stream and its pinned host slot."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.host = None
        self.copied = None  # event after the last copy out of ``host``

    def upload(self, frame: torch.Tensor, seq: int) -> torch.Tensor:
        """CPU frame number ``seq`` on the card, copied on this lane's
        stream."""
        span = trace.begin("serve.slot_wait", seq) if trace.ON else None
        if self.copied is not None:
            self.copied.synchronize()  # the slot's previous frame has left it
        if span is not None:
            trace.end(span)
        if self.host is None or self.host.shape != frame.shape or self.host.dtype != frame.dtype:
            self.host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
        span = trace.begin("serve.stage", seq) if trace.ON else None
        self.host.copy_(frame)
        if span is not None:
            trace.end(span)
        span = trace.begin("serve.h2d", seq) if trace.ON else None
        with torch.cuda.stream(self.stream):
            dev = self.host.to(self.device, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record(self.stream)
        if span is not None:
            trace.end(span)
        trace.count("serve.h2d_bytes", self.host.nbytes)
        return dev


class StreamExecutor:
    """Submit/poll interface over :func:`stream_map`'s discipline, for
    push-style sources (e.g. a camera callback).

    ``submit`` queues ``fn(frame)`` and returns the oldest pending result
    once ``depth`` are pending (the bound :func:`stream_map` keeps), else
    None; ``drain`` yields the rest.  Numpy frames go to
    ``config.default_device()`` (the card unless the caller asked for the
    CPU); a tensor is processed where it lies.
    """

    def __init__(self, fn: Callable, depth: int = 4):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._fn = fn
        self._depth = depth
        self._device = config.input_device()
        self._q: deque = deque()
        self._lanes = None
        self._seq = 0  # frames submitted

    def _run(self, frame, seq):
        """(result, event, ``seq``) of frame number ``seq``: on a lane's
        stream on the card, inline (event None) on the CPU."""
        on_card = (frame.device.type == "cuda" if isinstance(frame, torch.Tensor)
                   else self._device.type == "cuda")
        if not on_card:
            return self._fn(as_tensor(frame, self._device)), None, seq
        device = frame.device if isinstance(frame, torch.Tensor) else self._device
        if self._lanes is None:
            self._lanes = [_Lane(device) for _ in range(self._depth)]
        lane = self._lanes[seq % self._depth]
        if isinstance(frame, torch.Tensor):
            lane.stream.wait_stream(torch.cuda.current_stream(device))
            frame.record_stream(lane.stream)
        else:
            frame = lane.upload(torch.from_numpy(np.ascontiguousarray(frame)), seq)
        with torch.cuda.stream(lane.stream):
            out = self._fn(frame)
            done = torch.cuda.Event()
            done.record(lane.stream)
        return out, done, seq

    def _hand_over(self, item):
        out, done, seq = item
        span = trace.begin("serve.hand_over", seq) if trace.ON else None
        if done is not None:
            current = torch.cuda.current_stream(self._lanes[0].device)
            current.wait_event(done)
            _record(out, current)
        if span is not None:
            trace.end(span)
        return out

    def submit(self, frame):
        seq = self._seq
        self._seq += 1
        span = trace.begin("serve.submit", seq) if trace.ON else None
        try:
            self._q.append(self._run(frame, seq))
            if len(self._q) >= self._depth:  # same discipline as stream_map
                return self._hand_over(self._q.popleft())
            return None
        finally:
            if span is not None:
                trace.end(span)

    def drain(self):
        while self._q:
            yield self._hand_over(self._q.popleft())


def stream_map(fn: Callable, frames: Iterable, depth: int = 4) -> Iterator:
    """Yield ``fn(frame)`` for each frame, keeping up to ``depth`` frames
    in flight, in submission order.

    A yielded tensor may still be computing: reading it back (``.cpu()``,
    ``.item()``) blocks on that frame alone.  ``depth`` bounds device
    memory (backpressure): each yield hands back the OLDEST frame."""
    ex = StreamExecutor(fn, depth)
    for f in frames:
        out = ex.submit(f)
        if out is not None:
            yield out
    yield from ex.drain()
