"""track.replay_share: the tracker's CUDA graph replays over the frames it
tracked in the measured window (its counters ``track.graph_replays`` and
``track.frames``, read before and after the window); 1.0 when every frame
of the window was one replay.  Nothing where the program has no such
counters."""


def read(result):
    counters = result.run.extra.get("counters")
    if not counters:
        return None
    before, after = counters["before"], counters["after"]
    frames = after.get("track.frames", 0) - before.get("track.frames", 0)
    replays = after.get("track.graph_replays", 0) - before.get("track.graph_replays", 0)
    return replays / frames if frames > 0 else None
