"""align.host_us: the host's time in one alignment batch (``Aligner.batch``:
on a launch record's hit, the output's allocation and the one launch), no
synchronize: the mean of the harness's ``align.batch`` spans outside the
profiled sub-window."""


def read(result):
    count, total = result.trace["spans"].get("align.batch", (0, 0.0))
    return total / count * 1e6 if count else None
