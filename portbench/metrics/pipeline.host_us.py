"""pipeline.host_us: the host's time in one call of the pipeline
(``Preprocessor.batch``), no synchronize: the mean of the harness's
``pipeline.batch`` spans outside the profiled sub-window."""


def read(result):
    count, total = result.trace["spans"].get("pipeline.batch", (0, 0.0))
    return total / count * 1e6 if count else None
