"""align.idle_pct: the share of the window in which the card runs nothing,
at the pace of the unprofiled loop, over alignment batches: one less the
device's busy time a batch (the union of the kernels launched inside
``align.batch`` spans in the profiled sub-window, over those spans) over
the wall time a batch outside that sub-window (``device.idle_pct``'s
formula)."""


def read(result):
    trace, run = result.trace, result.run
    t = trace["timeline"]
    if not t:
        return None
    batches = t["span_counts"].get("align.batch", 0)
    busy = t["kernels_s"].get("align.batch", 0.0)
    rest, wall = run.steps - batches, run.elapsed_s - trace["section_s"]
    if not batches or busy <= 0 or rest <= 0 or wall <= 0:
        return None
    return 100.0 * (1 - (busy / batches) / (wall / rest))
