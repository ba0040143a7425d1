"""track.roofline: a tracking frame's least time (the larger of the
correlation's float32 operations at the card's published f32 rate and the
chain's least bytes at its published bandwidth: ``least_seconds`` of the
configuration's chain) over the device time of the kernels the frame
launched: the union of the profiled kernels launched inside ``track.frame``
spans, over the number of those spans.  Nothing when the card has no
published peak or the profiler saw no such kernel."""
from portbench import manifest


def read(result):
    t = result.trace["timeline"]
    if not t:
        return None
    least = manifest.chain(result.cfg).least_seconds(result.cfg, result.kind)
    busy = t["kernels_s"].get("track.frame", 0.0)
    frames = t["span_counts"].get("track.frame", 0)
    if least is None or busy <= 0 or not frames:
        return None
    return 100.0 * least * frames / busy
