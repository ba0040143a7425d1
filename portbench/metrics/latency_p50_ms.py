"""latency_p50_ms: the median, over every frame of the window, of the time
from when the frame was due to when the consumer held its finished output
(``StreamExecutor`` handed it over and a CUDA event recorded right after on
the consumer's stream completed); a frame that failed counts as missing."""
from portbench.stats import percentile


def read(result):
    lat = result.run.latency_s + [float("inf")] * result.run.failed
    return percentile(lat, 50) * 1e3 if lat else None
