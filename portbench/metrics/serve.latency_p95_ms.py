"""serve.latency_p95_ms: the 95th percentile, over every frame of the window,
of latency_p50_ms's samples (due time to the consumer holding the output; a
failed frame counts as missing).  Set by the host's stalls in the serving
layer's pinned copy, it swings too far from run to run to hold a bound, so
it is read beside the median and not bounded (PERF.md)."""
from portbench.stats import percentile


def read(result):
    lat = result.run.latency_s + [float("inf")] * result.run.failed
    return percentile(lat, 95) * 1e3 if lat else None
