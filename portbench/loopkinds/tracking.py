"""``tracking``: a closed loop of single NV21 frames through a tracker, one
frame a step.

The pool is ``pool`` distinct frames made from the seed on the card (the
configuration's chain: ``frames``, and the ``template`` every frame holds),
each with its own target position.  The system is aimed at the template
once; a step is ``system.frame(pool[i % pool])``, inside the harness span
``track.frame``, and the next frame is enqueued without waiting.  The
window ends with a synchronize.  Outputs are kept at seeded positions
(``sample_gap``) and at the window's last step, under the keys ``(j,
None)``: ``(network input, (x, y), score)``, copied (a tracker's outputs
outlive only its next few steps).

On the card the warm-up steps through the pool for ``warm_s`` seconds
after its first ``loops.WARMUP_BATCHES`` steps: H100s ran the steps of a
new process 1.5–3% slower for a while after it started, from a few to over
twenty seconds, and then within 0.2% of 477.8 µs a frame from process to
process (``PERF.md``), so a window that opened soon after the start held a
share of that slow start that differed from run to run.

``run.extra["counters"]`` holds the system's counters (the tracker's
``track.*``) read before and after the window; ``run.pool`` is
``{"frames", "template"}``.  When traced, the profiler starts and stops
once before the first step: a graph the tracker captures before the
profiler's first start may not show its kernels in the trace.

Parameters: ``pool``, ``warm_s``, ``sample_gap`` (mean steps between
kept outputs), ``trace_at`` and ``trace_items`` (the profiled sub-window).
"""
from __future__ import annotations

import time

import torch

from portbench import loops, manifest
from portbench.stats import sample_positions
from portbench.trace import Recorder


def kept(out, found):
    """A copy of a step's output and its ``((x, y), score)``."""
    (x, y), score = found
    copy = [v.clone() if isinstance(v, torch.Tensor) else v for v in (out, x, y, score)]
    return copy[0], (copy[1], copy[2]), copy[3]


def run(system, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device) -> loops.Run:
    chain = manifest.chain(cfg)
    cuda = torch.device(device).type == "cuda"
    rec = Recorder() if trace else None
    if rec is not None and cuda:
        rec.warm()
    pool = chain.frames(cfg, traffic["pool"], seed, 0, device)
    tmpl = chain.template(cfg, seed, device)
    system.aim(tmpl)
    system.check_route(pool[:1])
    size = len(pool)
    warm_until = time.perf_counter() + (traffic.get("warm_s", 0) if cuda else 0)
    i = 0
    while i < loops.WARMUP_BATCHES or time.perf_counter() < warm_until:
        system.frame(pool[i % size])
        i += 1
    loops.sync(device)
    keep = sample_positions(seed, traffic["sample_gap"])
    prof_at, prof_items = seconds * traffic.get("trace_at", 0.4), traffic.get("trace_items", 0)
    samples, k, next_keep, prof_left = [], 0, keep[0], -1
    before = system.counters()
    loops.settle()
    result = loops.Run(start_epoch=time.time())
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i, out = 0, None
    while True:
        j = i % size
        if trace:
            if prof_left < 0 and time.perf_counter() - t0 >= prof_at and prof_items:
                rec.start_profile()
                prof_left = prof_items
            a = time.perf_counter()
            out = system.frame(pool[j])
            rec.span("track.frame", a, time.perf_counter())
            if prof_left > 0:
                prof_left -= 1
                if prof_left == 0:
                    rec.stop_profile()
        else:
            out = system.frame(pool[j])
        if i == next_keep:
            samples.append(((j, None), kept(out, system.found)))
            k += 1
            next_keep = keep[k] if k < len(keep) else -1
        i += 1
        if time.perf_counter() >= deadline:
            break
    if i - 1 != (keep[k - 1] if k else -1):
        samples.append((((i - 1) % size, None), kept(out, system.found)))
    loops.sync(device)
    result.elapsed_s = time.perf_counter() - t0
    result.attempted = result.completed = result.steps = i
    result.samples = samples
    result.trace = rec.summary() if trace else None
    result.pool = {"frames": pool, "template": tmpl}
    result.extra = {"counters": {"before": before, "after": system.counters()}}
    return result
