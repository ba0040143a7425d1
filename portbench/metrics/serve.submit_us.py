"""serve.submit_us: the host's time in one ``StreamExecutor.submit`` (the copy
into the pinned slot, the slot wait, the enqueue and, once ``depth`` frames
are pending, the hand-over): the mean of the ``serve.submit`` spans outside
the profiled sub-window."""


def read(result):
    count, total = result.trace["spans"].get("serve.submit", (0, 0.0))
    return total / count * 1e6 if count else None
