"""``sharded``: a batch-sharded deployment, one process a card
(``PER_CARD``; ``ranks.py`` starts the ranks and joins them in one group).

Each rank runs a closed loop over its own pool of ``pool`` distinct batches
of ``batch`` frames on its card, each batch with its own crop top on the
device, the pool drawn from the seed and the rank.  A step is the
program's ``sharded`` step (``Preprocessor.batched`` over the mesh) on the
rank's shard at its top, span ``pipeline.batch``; then the exchange: each
output plane's upper-half mean (a per-frame statistic; the whole plane's
mean is 0 by construction) goes into the rank's rows of a table of the
global batch (one buffer, zeroed each step), zero in the other rows, and
one ``all_reduce(SUM)`` over the mesh's group fills every row on every
rank, span ``mesh.all_reduce``; a kept step's table is copied.  No
step waits for the card, except that a rank enqueues step i only once its
card has finished step i - ``ranks.LAG`` (``ranks.WindowEnd``).  The window
opens with a barrier and ends on the same step on every rank, with a
synchronize and then a barrier.

``check`` compares each kept table with the reference's table of that
step, built from every rank's inputs regenerated from the seed:
``stat_rel_err`` is the largest gap over the reference table's largest
value.  A table is per frame, so no two frames' statistics cancel, and a
run that leaves the exchange out keeps zeros in the other ranks' rows.

Parameters: ``batch`` (frames a rank), ``pool``, ``sample_gap`` (mean
steps between kept outputs), ``trace_at`` and ``trace_items`` (rank 0's
profiled sub-window), ``limits`` (``stat_rel_err``).
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from portbench import loops, manifest, ranks
from portbench.stats import sample_positions
from portbench.trace import Recorder

PER_CARD = True


def upper_means(out: torch.Tensor, into: torch.Tensor | None = None) -> torch.Tensor:
    """(frames, planes) means of the upper half of the rows of every
    trailing (h, w) plane of ``out``, written into ``into`` when given."""
    h, w = out.shape[-2:]
    planes = out.reshape(out.shape[0], -1, h, w)[:, :, :h // 2]
    return torch.mean(planes, dim=(-2, -1), out=into)


def barrier(group, dev: torch.device) -> None:
    if dev.type == "cuda":
        dist.barrier(group=group, device_ids=[dev.index])
    else:
        dist.barrier(group=group)


def run(system, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device) -> loops.Run:
    from torch.distributed.tensor import DTensor, Shard

    from vacv_tpu_torch.parallel import local_device, make_mesh

    mesh = make_mesh()
    group = mesh.get_group()
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    dev = local_device(mesh)
    n = traffic["batch"]
    pool, dev_tops, tops = loops.make_pool(cfg, traffic, seed, dev, salt=rank)
    system.check_route(pool[0])
    shards = [DTensor.from_local(f, mesh, [Shard(0)], run_check=False) for f in pool]
    step = system.sharded(mesh)
    size = len(pool)
    first = upper_means(step(shards[0], dev_tops[0]))
    table = first.new_zeros((world * n, first.shape[1]))

    def exchange(out, rec):
        table.zero_()
        upper_means(out, into=table[rank * n:(rank + 1) * n])
        a = time.perf_counter()
        dist.all_reduce(table, op=dist.ReduceOp.SUM, group=group)
        if rec is not None:
            rec.span("mesh.all_reduce", a, time.perf_counter())

    for i in range(loops.WARMUP_BATCHES):
        exchange(step(shards[i % size], dev_tops[i % size]), None)
    loops.sync(dev)
    keep = sample_positions(seed, traffic["sample_gap"])
    rec = Recorder() if trace else None
    if rec is not None and dev.type == "cuda":
        rec.warm()
    events = [torch.cuda.Event() for _ in range(ranks.LAG)] if dev.type == "cuda" else None
    prof_at, prof_items = seconds * traffic.get("trace_at", 0.4), traffic.get("trace_items", 0)
    samples, tables, k, next_keep, prof_left = [], [], 0, keep[0], -1
    loops.settle()
    barrier(group, dev)
    run = loops.Run(start_epoch=time.time())
    t0 = time.perf_counter()
    end = ranks.WindowEnd(t0 + seconds)
    i, out = 0, None
    while True:
        j = i % size
        if events is not None and i >= ranks.LAG:
            events[i % ranks.LAG].synchronize()
        if trace:
            if prof_left < 0 and time.perf_counter() - t0 >= prof_at and prof_items:
                rec.start_profile()
                prof_left = prof_items
            a = time.perf_counter()
            out = step(shards[j], dev_tops[j])
            rec.span("pipeline.batch", a, time.perf_counter())
        else:
            out = step(shards[j], dev_tops[j])
        exchange(out, rec)
        if events is not None:
            events[i % ranks.LAG].record()
        if prof_left > 0:
            prof_left -= 1
            if prof_left == 0:
                rec.stop_profile()
        if i == next_keep:
            samples.append(((j, tops[j]), out))
            tables.append((j, table.clone()))
            k += 1
            next_keep = keep[k] if k < len(keep) else -1
        i += 1
        if end.done(i):
            break
    loops.sync(dev)
    barrier(group, dev)
    run.elapsed_s = time.perf_counter() - t0
    if not samples or samples[-1][1] is not out:
        samples.append((((i - 1) % size, tops[(i - 1) % size]), out))
        tables.append(((i - 1) % size, table.clone()))
    run.attempted = run.completed = i * n * world
    run.steps = i
    run.samples = samples
    run.trace = rec.summary() if trace else None
    run.pool = pool
    run.extra = {"tables": tables, "world": world}
    return run


def check(run: loops.Run, cfg: dict, traffic: dict, seed: int, device) -> dict:
    """``stat_rel_err`` over every kept table (module docstring)."""
    chain = manifest.chain(cfg)
    world, n, size = run.extra["world"], traffic["batch"], traffic["pool"]
    tops = [chain.tops(cfg, size, seed, r) for r in range(world)]
    worst = 0.0 if run.extra["tables"] else math.inf
    for j, table in run.extra["tables"]:
        ref = torch.cat([upper_means(chain.reference(
            chain.frames(cfg, n, seed, loops.pool_salt(r, j), device), cfg, tops[r][j]))
            for r in range(world)])
        gap = float((table.to(torch.float64) - ref).abs().max() / ref.abs().max())
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return {"stat_rel_err": worst}
