"""gen.late_p95_ms: the 95th percentile, over every frame of the window, of
how late the load generator sent the frame against its due time."""
from portbench.stats import percentile


def read(result):
    late = result.run.late_s
    return percentile(late, 95) * 1e3 if len(late) else None
