"""Timing utilities: scope timers, synchronized wall-clock timing, the
loop-slope device time and a profiler trace.

The counterpart of ``vacv_tpu/utils/perf.py``, itself the parity of
``AutoPerf`` / ``TIME_PERF`` (reference ``src/util/perf_util.h:7-17``).
PyTorch returns before the card has run what it was given, so timing
that means the card either synchronizes (``time_fn``) or brackets the
launches with CUDA events (``device_time``).  On CPU tensors both use
``time.perf_counter``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch


@contextmanager
def profiler_trace(logdir: str):
    """``torch.profiler`` scope over CPU and CUDA activities (the
    counterpart of the JAX version's ``jax.profiler`` trace); on exit it
    writes a Chrome trace, ``trace.json`` for chrome://tracing or
    Perfetto, into ``logdir``.  The yielded profile's ``key_averages()``
    has the device time per kernel once the scope has closed:

        with profiler_trace("build/trace") as prof:
            out = pipeline(batch)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


class Timer:
    """Accumulating wall-clock timer (milliseconds)."""

    def __init__(self) -> None:
        self.ms = 0.0

    @contextmanager
    def scope(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.ms += (time.perf_counter() - t0) * 1e3


@contextmanager
def time_perf(out: dict, key: str = "ms"):
    """``TIME_PERF``-style scope: writes elapsed ms into ``out[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        out[key] = (time.perf_counter() - t0) * 1e3


def _on_card(result) -> bool:
    """Does a result (a tensor, or a tuple/list holding tensors) lie on a
    CUDA device?"""
    if isinstance(result, torch.Tensor):
        return result.device.type == "cuda"
    if isinstance(result, (tuple, list)):
        return any(_on_card(r) for r in result)
    return False


def device_time(step_fn, *args, iters: int = 32, base_iters: int = 2) -> float:
    """Per-iteration time (seconds) of ``step_fn`` by the loop-slope method.

    ``step_fn(i, *args)`` runs one iteration and should depend on the
    loop index ``i`` (e.g. a one-row window shift ``i % 2``), the
    contract of the JAX version, whose jitted loop a compiler could
    otherwise hoist; PyTorch hoists nothing, but callers port unchanged.
    ``base_iters`` and ``iters`` repetitions are timed back to back, and
    the slope between them cancels the constant cost of starting and
    ending a measurement.  When the first result lies on the card the
    repetitions are bracketed by CUDA events on the current stream (the
    card's own time for the launches as the host makes them: a call
    shorter than its host cost measures the host); otherwise by
    ``time.perf_counter``.  Small and large samples alternate so that
    slow drift hits both sides alike; when the difference is buried in
    the jitter of the small sample, the gap widens up to 512 iterations.
    """
    cuda = _on_card(step_fn(0, *args))

    def run(k):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(k):
                step_fn(i, *args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for i in range(k):
            step_fn(i, *args)
        return time.perf_counter() - t0

    run(base_iters)  # warm both sizes
    run(iters)
    while True:
        t_small = t_big = float("inf")
        jitter, prev_small = 0.0, None
        for _ in range(3):
            s = run(base_iters)
            if prev_small is not None:
                jitter = max(jitter, abs(s - prev_small))
            prev_small = s
            t_small = min(t_small, s)
            t_big = min(t_big, run(iters))
        delta = t_big - t_small
        if delta > 3 * jitter or iters >= 512:
            return max(delta / (iters - base_iters), 1e-9)
        iters = min(iters * 4, 512)
        run(iters)  # warm the wider loop


def time_fn(fn, *args, iters: int = 10, warmup: int = 2):
    """Time ``fn(*args)`` with device synchronization.

    Returns ``(best_ms, mean_ms, last_result)``.  Each call is timed on
    the host clock up to ``torch.cuda.synchronize()`` when its result lies
    on the card (a step or request time, launches and host work
    included).  Warm-up calls absorb the first-call costs (the kernel
    build, the allocator), as the reference averages over 10 repetitions
    (cv_profile.cpp:14)."""

    def call():
        out = fn(*args)
        if _on_card(out):
            torch.cuda.synchronize()
        return out

    result = None
    for _ in range(warmup):
        result = call()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        result = call()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), sum(times) / len(times), result
