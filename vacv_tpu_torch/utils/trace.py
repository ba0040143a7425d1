"""The port's tracer: counters, always on, and spans, on request.

Counters count work where it is done: the route that served a call
(``config.record_kernel``), the calls into the kernel library
(``native.calls``), the device tables made (``tables.made``), the bytes a
served frame sends to the card (``serve.h2d_bytes``).  ``count`` is one
dict update.

Spans time the parts of a call on the ``time.perf_counter_ns`` clock.  They
are off until ``enable()``, and a span site then costs the test of ``ON``
and nothing else::

    span = trace.begin("pipeline.batch") if trace.ON else None
    try:
        ...
    finally:
        if span is not None:
            trace.end(span)

Open spans form a stack, so each span has a parent.  Per name the tracer
keeps the count, the total time and the self time: the total less the time
its child spans cover.  ``begin`` reads the clock on entry and as its last
step, ``end`` as its first step and on exit: a span's time runs from
``begin``'s last read to ``end``'s first, and its parent counts the span
from ``begin``'s first read to ``end``'s last as a child's, so a child's
bookkeeping stays out of its parent's self time.  That bookkeeping is
summed as ``cost_ns``, the tracer's own cost as measured in place; what
stays in a parent's self time a child span is the site's test of ``ON``
and the calls into ``begin`` and ``end`` up to their clock reads.  A span
that an exception left open is dropped when a span below it ends.  With
``keep_events(True)`` every span that ends is kept as an event as well
(name, start and end in ns, the parent's name and the frame number a
serving span carries), up to ``EVENT_CAP`` of them; the events past the cap
are counted as ``trace.events_dropped``.

``snapshot()`` gives counters, spans, events and ``cost_ns`` as plain data;
``reset()`` clears all but the counters.

One stack serves the process: the tracer assumes that one thread at a time
drives a ``Preprocessor`` or a ``StreamExecutor``.  It imports nothing
beyond the standard library.
"""
from __future__ import annotations

import time

EVENT_CAP = 200_000

ON = False  # spans are recorded
_keep = False  # ended spans are kept as events too
_counts: dict[str, int] = {}
_stack: list[list] = []  # open: [name, start ns, child ns, frame number, depth, entry ns]
_spans: dict[str, list[int]] = {}  # name -> [count, total ns, self ns]
_events: list[tuple] = []  # (name, start ns, end ns, parent's name, frame number)
_cost = 0  # ns inside begin and end of the spans ended, outside their own time


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    return _counts.get(name, 0)


def reset_counts() -> None:
    _counts.clear()


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def keep_events(on: bool) -> None:
    global _keep
    _keep = bool(on)


def begin(name: str, seq: int | None = None) -> list:
    """Open span ``name`` (of frame ``seq``) inside the innermost open one;
    returns it for ``end``."""
    span = [name, 0, 0, seq, len(_stack), time.perf_counter_ns()]
    _stack.append(span)
    span[1] = time.perf_counter_ns()
    return span


def end(span: list) -> None:
    """Close ``span`` and any span an exception left open inside it."""
    global _cost
    t1 = time.perf_counter_ns()
    name, t0, child, seq, depth, entry = span
    if depth >= len(_stack) or _stack[depth] is not span:
        return  # the tracer was reset since it began
    del _stack[depth:]
    total = t1 - t0
    agg = _spans.get(name)
    if agg is None:
        agg = _spans[name] = [0, 0, 0]
    agg[0] += 1
    agg[1] += total
    agg[2] += total - child
    parent = _stack[-1] if _stack else None
    if _keep:
        if len(_events) < EVENT_CAP:
            _events.append((name, t0, t1, parent and parent[0], seq))
        else:
            count("trace.events_dropped")
    out = time.perf_counter_ns()
    _cost += out - entry - total
    if parent is not None:
        parent[2] += out - entry


def reset() -> None:
    """Forget spans, open ones included, events and the tracer's cost; keep
    the counters."""
    global _cost
    _cost = 0
    _stack.clear()
    _spans.clear()
    _events.clear()


def snapshot() -> dict:
    """``{"counters": {name: n}, "spans": {name: {"count", "total_ns",
    "self_ns"}}, "events": [{"name", "start_ns", "end_ns", "parent",
    "seq"}], "cost_ns": n}``, copies of the tracer's state."""
    return {
        "counters": dict(_counts),
        "spans": {k: {"count": c, "total_ns": t, "self_ns": s} for k, (c, t, s) in _spans.items()},
        "events": [{"name": n, "start_ns": a, "end_ns": b, "parent": p, "seq": q}
                   for n, a, b, p, q in _events],
        "cost_ns": _cost,
    }
