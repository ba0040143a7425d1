"""Constant tables kept on the card between calls, safe across CUDA streams.

Some ops keep small constant tables on the device in an LRU cache, so that
a call does not upload them again: the fused kernel's tap tables
(``ops/cuda/preprocess.py``), the chain's resize weights
(``ops/resize.py``) and the box-sum bands of the window sums' plain
version (``ops/cuda/window_sum.py``).  ``models/serving.py`` runs frames on several
CUDA streams at once.  A table's memory belongs to the stream that was
current when it was made: once the cache drops it, PyTorch's caching
allocator hands that memory to the next allocation on that stream, ordered
after that stream's work alone.  A kernel queued on another stream that
still reads the table would then read another tensor's bytes.

``stream_cached`` keys the cache by the current stream as well, so a table
is only ever read on the stream it was made on and its memory is reused
only behind every read of it.  That costs one read of the current stream's
raw handle a lookup; calling ``Tensor.record_stream`` on every table at
every use would need the current stream as a ``torch.cuda.Stream`` object
and one call a table (``chip_smoke.py`` times both).
"""
from __future__ import annotations

import functools

import torch

from ..utils import trace


def stream_key(device: torch.device) -> int | None:
    """The raw handle (``cudaStream_t``) of ``device``'s current CUDA
    stream, what ``torch.cuda.current_stream(device).cuda_stream`` gives
    without building a Stream object; None off the card.  Every launch in
    ``ops/cuda/`` passes the library its stream from here."""
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def stream_cached(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function whose last argument
    is the device its tables go to, keyed by that device's current CUDA
    stream too.  The wrapper keeps ``cache_clear`` and ``cache_info``.
    Each miss, a table made and copied to the device, counts as
    ``tables.made`` in the port's tracer."""

    def wrap(make):
        @functools.lru_cache(maxsize=maxsize)
        def cached(*args, stream):
            trace.count("tables.made")
            return make(*args)

        @functools.wraps(make)
        def table(*args):
            return cached(*args, stream=stream_key(args[-1]))

        table.cache_clear = cached.cache_clear
        table.cache_info = cached.cache_info
        return table

    return wrap
