"""track.idle_pct: the share of the window in which the card runs nothing,
at the pace of the unprofiled loop, over tracking steps: one less the
device's busy time a frame (the union of the kernels and copies launched
inside ``track.frame`` spans in the profiled sub-window, a graph's kernels
through its launch, over those spans) over the wall time a frame outside
that sub-window (``device.idle_pct``'s formula)."""


def read(result):
    trace, run = result.trace, result.run
    t = trace["timeline"]
    if not t:
        return None
    frames = t["span_counts"].get("track.frame", 0)
    busy = t["kernels_s"].get("track.frame", 0.0)
    rest, wall = run.steps - frames, run.elapsed_s - trace["section_s"]
    if not frames or busy <= 0 or rest <= 0 or wall <= 0:
        return None
    return 100.0 * (1 - (busy / frames) / (wall / rest))
