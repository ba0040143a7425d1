"""The general load generator: one function for each kind of loop.

A traffic file names its ``loop`` and gives the loop's parameters; a new
mix of an existing kind is a data file and no code.

* ``resident``: a closed loop over batches that already lie on the card:
  ``batch`` frames each, a pool of ``pool`` distinct batches made from the
  seed, each with its own crop top on the device.  The next batch is
  enqueued without waiting; the window ends with a synchronize.
* ``served``: an open loop of single host frames through
  ``StreamExecutor(depth)``: ``cameras`` cameras at ``fps`` each with
  ``jitter_ms`` of jitter (``stats.arrival_schedule``), from a host pool
  of ``pool`` pageable frames.  A frame's latency runs from when it was
  due to when a CUDA event, recorded on the consumer's stream right after
  the executor handed the frame over, has completed.

Each loop returns a ``Run``: what was attempted and completed, the window,
the outputs kept for the check (positions drawn from the seed) and, when
traced, the ``trace.Recorder`` summary.  The inputs come from the
configuration's chain (``manifest.chain``).

A loop kind that ``LOOPS`` lacks is a module ``loopkinds/<loop>.py`` with
``run(system, cfg, traffic, seed, seconds, trace, device) -> Run``, and
optionally ``check(run, cfg, traffic, seed, device) -> numbers``, numbers
of its own that the traffic's ``limits`` bound, and ``PER_CARD = True``
for a loop run as one process a card (``ranks.py``).
"""
from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from . import manifest
from .stats import arrival_schedule, rng, sample_positions
from .trace import Recorder

WARMUP_BATCHES = 16  # calls before the window: builds, tables, the allocator


@dataclass
class Run:
    attempted: int = 0           # frames offered
    completed: int = 0           # frames whose output was complete in the window
    failed: int = 0
    elapsed_s: float = 0.0       # the measured window
    start_epoch: float = 0.0     # time.time() when the window opened
    latency_s: list = field(default_factory=list)
    samples: list = field(default_factory=list)   # (key, output) pairs for the check
    trace: dict | None = None                     # the Recorder summary, when traced
    late_s: list = field(default_factory=list)
    steps: int = 0
    pool: list = field(default_factory=list)      # the inputs the samples index
    extra: dict = field(default_factory=dict)     # what a loop kind keeps for its own check


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def settle() -> None:
    """Collect once, then move every object of the set-up out of the
    collector's reach (``gc.freeze``), as a long-running server does after
    start-up: a collection inside the window walks only what the window
    made."""
    gc.collect()
    gc.freeze()


def pool_salt(salt: int, k: int) -> int:
    """The seed's salt of batch ``k`` of the pool drawn with ``salt``."""
    return 100 * salt + k


def make_pool(cfg: dict, traffic: dict, seed: int, device, salt: int = 0):
    """(pool of frame batches, their tops as 0-d int32 tensors, as ints)."""
    n, size = traffic["batch"], traffic["pool"]
    chain = manifest.chain(cfg)
    pool = [chain.frames(cfg, n, seed, pool_salt(salt, k), device) for k in range(size)]
    tops = chain.tops(cfg, size, seed, salt)
    dev_tops = [torch.tensor(t, dtype=torch.int32, device=device) for t in tops]
    return pool, dev_tops, tops


def resident(system, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device) -> Run:
    pool, dev_tops, tops = make_pool(cfg, traffic, seed, device)
    system.check_route(pool[0])
    size = len(pool)
    for i in range(WARMUP_BATCHES):
        system.batch(pool[i % size], dev_tops[i % size])
    sync(device)
    keep = sample_positions(seed, traffic["sample_gap"])
    rec = Recorder() if trace else None
    if rec is not None and torch.device(device).type == "cuda":
        rec.warm()
    prof_at, prof_items = seconds * traffic.get("trace_at", 0.4), traffic.get("trace_items", 0)
    samples, k, next_keep, prof_left = [], 0, keep[0], -1
    settle()
    run = Run(start_epoch=time.time())
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
            out = system.batch(pool[j], dev_tops[j])
            rec.span("pipeline.batch", a, time.perf_counter())
            if prof_left > 0:
                prof_left -= 1
                if prof_left == 0:
                    rec.stop_profile()
        else:
            out = system.batch(pool[j], dev_tops[j])
        if i == next_keep:
            samples.append(((j, tops[j]), out))
            k += 1
            next_keep = keep[k] if k < len(keep) else -1
        i += 1
        if time.perf_counter() >= deadline:
            break
    sync(device)
    run.elapsed_s = time.perf_counter() - t0
    if not samples or samples[-1][1] is not out:
        samples.append((((i - 1) % size, tops[(i - 1) % size]), out))
    run.attempted = run.completed = i * traffic["batch"]
    run.steps = i
    run.samples = samples
    run.trace = rec.summary() if trace else None
    run.pool = pool
    return run


def _wait_until(t: float) -> None:
    """Sleep until ``perf_counter()`` reaches ``t``: in ``time.sleep``
    while more than a millisecond is left, then in ``time.sleep(0)``, which
    lets other threads run."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(left - 1e-3 if left > 2e-3 else 0)


def served(system, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
           device) -> Run:
    from vacv_tpu_torch.models.serving import StreamExecutor

    cuda = torch.device(device).type == "cuda"
    size = traffic["pool"]
    frames = manifest.chain(cfg).frames(cfg, size, seed, 0, device)
    system.check_route(frames[:1])
    host = [f.cpu().numpy() for f in frames]  # pageable frames, as a camera delivers
    del frames
    due, _ = arrival_schedule(seed, traffic["cameras"], traffic["fps"],
                              traffic["jitter_ms"] / 1e3, seconds)
    r = rng(seed, 13)
    which = r.integers(0, size, size=len(due))
    keep = r.random(len(due)) < traffic["sample_share"]
    keep[-1] = True
    ex = StreamExecutor(system.frame, depth=traffic["depth"])
    for i in range(WARMUP_BATCHES):
        ex.submit(host[i % size])
    for _ in ex.drain():
        pass
    sync(device)

    rec = Recorder() if trace else None
    if rec is not None and cuda:
        rec.warm()
    prof_at, prof_items = seconds * traffic.get("trace_at", 0.4), traffic.get("trace_items", 0)
    prof_left = -1
    finish = np.full(len(due), np.inf)  # s after t0 when the consumer held the output
    inflight = deque()  # (frame, its hand-over event), resolved as they complete
    kept = []
    pending = deque()
    late = np.empty(len(due))

    def resolve(wait: bool) -> None:
        while inflight and (wait or inflight[0][1].query()):
            i, ev = inflight.popleft()
            finish[i] = origin.elapsed_time(ev) / 1e3

    def hand_over(out):
        i = pending.popleft()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            inflight.append((i, ev))
            resolve(False)
        else:
            finish[i] = time.perf_counter() - t0
        if keep[i]:
            kept.append(((int(which[i]), None), out))

    settle()
    run = Run(start_epoch=time.time())
    if cuda:
        origin = torch.cuda.Event(enable_timing=True)
        origin.record()
    t0 = time.perf_counter()
    for i in range(len(due)):
        if trace:
            if prof_left < 0 and due[i] >= prof_at and prof_items:
                rec.start_profile()
                prof_left = prof_items
            a = time.perf_counter()
            _wait_until(t0 + due[i])
            b = time.perf_counter()
            rec.span("gen.wait", a, b)
            late[i] = b - t0 - due[i]
            pending.append(i)
            out = ex.submit(host[which[i]])
            rec.span("serve.submit", b, time.perf_counter())
            if prof_left > 0:
                prof_left -= 1
                if prof_left == 0:
                    rec.stop_profile()
        else:
            _wait_until(t0 + due[i])
            late[i] = time.perf_counter() - t0 - due[i]
            pending.append(i)
            out = ex.submit(host[which[i]])
        if out is not None:
            hand_over(out)
    for out in ex.drain():
        hand_over(out)
    sync(device)
    run.elapsed_s = time.perf_counter() - t0
    if cuda:
        resolve(True)
    run.latency_s = list(finish - due)
    run.late_s = list(late)
    run.attempted = len(due)
    run.completed = int(np.sum(finish <= seconds))
    run.samples = kept
    run.trace = rec.summary() if trace else None
    run.pool = host
    return run


LOOPS = {"resident": resident, "served": served}


def find(name: str):
    """The loop kind a traffic names: a namespace with ``run`` (and the
    optional ``check`` and ``PER_CARD``) for a kind of ``LOOPS``, else the
    module ``loopkinds/<name>.py``."""
    if name in LOOPS:
        return SimpleNamespace(run=LOOPS[name])
    return manifest.module("loopkinds", name)
