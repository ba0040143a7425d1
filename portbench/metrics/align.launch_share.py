"""align.launch_share: the alignment kernel's launches (route counter
``align_faces``) over the Aligner's batches (counter ``align.batches``) in
the measured window, both read before and after it; 1.0 when every batch
was one launch.  Nothing where the program has no such counters."""


def read(result):
    counters = result.run.extra.get("counters")
    if not counters:
        return None
    before, after = counters["before"], counters["after"]
    batches = after.get("align.batches", 0) - before.get("align.batches", 0)
    launches = after.get("align_faces", 0) - before.get("align_faces", 0)
    return launches / batches if batches > 0 else None
