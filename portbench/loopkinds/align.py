"""``align``: a closed loop of face-alignment batches that already lie on the
card.

The pool is ``pool`` distinct batches of ``batch`` frames made from the
seed on the card (the configuration's chain: ``frames``) and ``tables``
face tables (frame indices and forward matrices; the chain's
``face_tables``: each run of ``batches_per_count`` tables alike in faces
per frame, the counts drawn anew for the next run, so K moves from run to
run, the faces taken in turn from a pool of ``faces``) on the card too;
``tables`` is a multiple of ``pool``.  Table ``t`` goes with frame batch
``t % pool``.  ``loops.WARMUP_BATCHES`` batches go before the window, the
last of them on table 0, and window step ``i`` is ``system.batch(frames,
(index, matrices))`` of table ``(i + 1) % tables``, so the window's first
batches continue the warm-up's run of face counts, inside the harness span
``align.batch``; the next batch is enqueued without waiting, and the window
ends with a synchronize.  So many tables (tens of thousands of runs of
face counts) that a seed moves the window's face count by ~0.1%, where a
table a frame batch (8) would move it by ~8%: each table's K spreads by
~24%.  Outputs are kept at seeded positions (``sample_gap``) and at the
window's last step, under the keys ``(t, None)``; each is a new tensor of
its batch.  ``frames_per_s`` counts camera frames: ``batch`` a step.

``run.pool`` holds each table's (frames, index, matrices); ``run.extra``
the system's counters read before and after the window (``counters``:
``align.batches``, ``align.rois``, the route counters), the host face
tables (``tables``) and, when traced, how many batches of each table ran in
the profiled sub-window (``profiled``).

Parameters: ``batch``, ``pool``, ``tables``, ``faces``, ``sample_gap`` (mean steps
between kept outputs), ``trace_at`` and ``trace_items`` (the profiled
sub-window).
"""
from __future__ import annotations

import time

import torch

from portbench import loops, manifest
from portbench.stats import sample_positions
from portbench.trace import Recorder


def run(system, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device) -> loops.Run:
    chain = manifest.chain(cfg)
    n, size, number = traffic["batch"], traffic["pool"], traffic["tables"]
    if number % size:
        raise ValueError(f"tables ({number}) must be a multiple of pool ({size})")
    frames = [chain.frames(cfg, n, seed, loops.pool_salt(0, k), device) for k in range(size)]
    tables = chain.face_tables(cfg, n, number, seed, 0, traffic["faces"])
    rois = chain.tables_on_device(tables, device)
    system.check_route(frames[0])
    for i in range(1 - loops.WARMUP_BATCHES, 1):
        t = i % number
        system.batch(frames[t % size], rois[t])
    loops.sync(device)
    keep = sample_positions(seed, traffic["sample_gap"])
    rec = Recorder() if trace else None
    if rec is not None and torch.device(device).type == "cuda":
        rec.warm()
    prof_at, prof_items = seconds * traffic.get("trace_at", 0.4), traffic.get("trace_items", 0)
    samples, k, next_keep, prof_left = [], 0, keep[0], -1
    profiled = [0] * number
    before = system.counters()
    loops.settle()
    result = loops.Run(start_epoch=time.time())
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i, out = 0, None
    while True:
        j = (i + 1) % number
        if trace:
            if prof_left < 0 and time.perf_counter() - t0 >= prof_at and prof_items:
                rec.start_profile()
                prof_left = prof_items
            a = time.perf_counter()
            out = system.batch(frames[j % size], rois[j])
            rec.span("align.batch", a, time.perf_counter())
            if prof_left > 0:
                profiled[j] += 1
                prof_left -= 1
                if prof_left == 0:
                    rec.stop_profile()
        else:
            out = system.batch(frames[j % size], rois[j])
        if i == next_keep:
            samples.append(((j, None), out))
            k += 1
            next_keep = keep[k] if k < len(keep) else -1
        i += 1
        if time.perf_counter() >= deadline:
            break
    loops.sync(device)
    result.elapsed_s = time.perf_counter() - t0
    if not samples or samples[-1][1] is not out:
        samples.append(((i % number, None), out))
    result.attempted = result.completed = i * n
    result.steps = i
    result.samples = samples
    result.trace = rec.summary() if trace else None
    result.pool = [(frames[t % size], *r) for t, r in enumerate(rois)]
    result.extra = {"counters": {"before": before, "after": system.counters()},
                    "tables": tables, "profiled": profiled if trace else None}
    return result
