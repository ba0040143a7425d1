"""kernels_roofline: the least time of the cell's whole chain a batch
(``work.chain_bytes`` over the card's published bandwidth) over the device
time of the kernels the batch launched: the union of the profiled kernels
launched inside ``pipeline.batch`` spans, over the number of those spans.
Nothing when the card has no published peak or the profiler saw no such
kernel."""
from portbench import work


def read(result):
    least = work.least_seconds(result.cfg, result.traffic["batch"], result.kind)
    t = result.trace["timeline"]
    if least is None or not t:
        return None
    busy = t["kernels_s"].get("pipeline.batch", 0.0)
    batches = t["span_counts"].get("pipeline.batch", 0)
    return 100.0 * least * batches / busy if busy > 0 and batches else None
