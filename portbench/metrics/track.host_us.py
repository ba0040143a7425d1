"""track.host_us: the host's time in one tracking step (``Tracker.step``:
on the card, the copy into the graph's input, the replay and the clones),
no synchronize: the mean of the harness's ``track.frame`` spans outside the
profiled sub-window."""


def read(result):
    count, total = result.trace["spans"].get("track.frame", (0, 0.0))
    return total / count * 1e6 if count else None
