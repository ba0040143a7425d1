"""device.idle_pct: the share of the window in which the card runs nothing,
at the pace of the unprofiled loop: one less the device's busy time a batch
(the union of the kernels and copies launched inside ``pipeline.batch``
spans in the profiled sub-window, over those spans) over the wall time a
batch outside that sub-window.  The profiler slows the host's enqueue, so
the idle share of the profiled sub-window itself (``device.busy_s`` over
``device.window_s`` of the result line) reads high in a host-bound cell."""


def read(result):
    trace, run = result.trace, result.run
    t = trace["timeline"]
    if not t:
        return None
    batches = t["span_counts"].get("pipeline.batch", 0)
    busy = t["kernels_s"].get("pipeline.batch", 0.0)
    rest, wall = run.steps - batches, run.elapsed_s - trace["section_s"]
    if not batches or busy <= 0 or rest <= 0 or wall <= 0:
        return None
    return 100.0 * (1 - (busy / batches) / (wall / rest))
