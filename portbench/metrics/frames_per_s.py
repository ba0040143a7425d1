"""frames_per_s: frames whose output was complete, over the whole measured
window (host clock; the window ends with a synchronize)."""


def read(result):
    run = result.run
    return run.completed / run.elapsed_s if run.elapsed_s > 0 and run.completed else None
