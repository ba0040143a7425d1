"""mesh.collective_us: rank 0's device time a step of the exchange's
collective kernel: the union of the kernels launched inside the harness's
``mesh.all_reduce`` spans in the profiled sub-window (the ``all_reduce``
launches NCCL's kernel alone), over the number of those spans.  The kernel
runs from when rank 0's card reaches it until every rank's part has come,
so it holds the wait for the slowest rank."""


def read(result):
    t = result.trace["timeline"]
    if not t:
        return None
    busy = t["kernels_s"].get("mesh.all_reduce", 0.0)
    steps = t["span_counts"].get("mesh.all_reduce", 0)
    return busy / steps * 1e6 if busy > 0 and steps else None
