"""The tracer's cost in place, and the host path split into its spans.

Runs config 4 (32 x 1080p BGR, crop 1792x1036 at (64, 28), bilinear to
224x224, CHW f32, self-statistics normalize) and config 5 (16 x 1440p, the
forward matrix [[0.9, 0.03, 40], [-0.03, 0.9, 25]] to 1216x684 on the crop
(64, 36)-(2496, 1404), then config 4's tail) as closed loops of batches on
the card, each batch with its own crop top on the device, and config 4 as
a served stream of pageable 1080p frames through ``StreamExecutor(depth=4)``
at 780 frames/s.  Each case runs blocks of calls with the tracer's spans
off, on, and on with a probe, in turns:

- off and on: the host time of a call (``Preprocessor.batch`` or
  ``StreamExecutor.submit``, no synchronize); ``on_cost_us`` is the median
  over rounds of on less off.
- on: the program's spans a call (count, total and self time) and the
  tracer's own cost, measured in place by its clock reads
  (``trace.snapshot()["cost_ns"]``), a call and a span.
- probe: an empty span at each wrapper's route count, inside its ``ops.*``
  span, between two clock reads, less an empty pair of clock reads there and
  less what the tracer measured of the probe.  That residual (the site's test
  of ``trace.ON``, the calls into ``begin`` and ``end`` up to their clock
  reads) is what a child span leaves in its parent's self time; ``self_net_us``
  takes it off each span's self time once for each child.  ``explained_us``
  is the tracer's cost a call plus the residual for each span.  The probe
  blocks' host time less the on blocks' (``probe_marginal_us``) is what one
  more span costs in place, and each span's self time there
  (``self_probed_us``) shows where that cost lands.
- every block: the garbage collector's runs and time a call (``gc_us``).
- all the timed blocks: the launch records' hits and the records made
  (``records``; after the warm-up every batch should be a hit, so the spans
  are the hit path's), and the tables made and library calls a call.

Prints one JSON line a case and writes the list to ``--out``::

    python3 -m vacv_tpu_torch.profile.trace_cost --out chiprun_out/trace_cost.json

``--small`` runs small frames on the CPU, to check the script.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import time

import numpy as np
import torch

from .. import config
from ..core.types import VRect
from ..models import PreprocessConfig, Preprocessor, StreamExecutor
from ..utils import trace

_WARP = ((0.9, 0.03, 40.0), (-0.03, 0.9, 25.0))
# name: (frame h, w; crop; warp; out size; batch; highest top offset)
CASES = {
    "config4": ((1080, 1920), VRect(64, 28, 1856, 1064), None, (224, 224), 32, 44),
    "config5": ((1440, 2560), VRect(64, 36, 2496, 1404), (_WARP, (1216, 684)), (224, 224), 16,
                72),
}
SMALL = {
    "config4": ((48, 64), VRect(4, 6, 60, 42), None, (16, 12), 4, 4),
    "config5": ((48, 64), VRect(2, 3, 62, 45), (_WARP, (40, 30)), (16, 12), 4, 2),
}
MODES = ("off", "on", "probe")
_COUNTERS = ("pipeline.record_hits", "pipeline.records_made", "tables.made", "native.calls")


class _Probe:
    """An empty span at every route count, timed in place."""

    def __init__(self):
        self.residual_ns: list[int] = []
        self.site_ns: list[int] = []
        self._count = config.record_kernel

    def __call__(self, name, n=1):
        clock = time.perf_counter_ns
        c = clock()
        d = clock()
        cost = trace._cost
        a = clock()
        span = trace.begin("probe") if trace.ON else None
        if span is not None:
            trace.end(span)
        b = clock()
        self.site_ns.append(b - a)
        self.residual_ns.append((b - a) - (d - c) - (trace._cost - cost))
        self._count(name, n)


class _Collections:
    """The garbage collector's runs and their time, from its callbacks."""

    def __init__(self):
        self.ns, self.runs, self._t = 0, 0, 0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter_ns()
        else:
            self.ns += time.perf_counter_ns() - self._t
            self.runs += 1


def _frames(shape, n, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, *shape, 3), dtype=torch.uint8, device=device, generator=g)


def _resident(case, device, calls):
    (h, w), crop, warp, out, n, high = case
    pre = Preprocessor(PreprocessConfig(crop_rect=crop, warp=warp, out_size=out), device=device)
    pool = [_frames((h, w), n, k, device) for k in range(4)]
    tops = [torch.tensor(int(t), dtype=torch.int32, device=device)
            for t in np.random.default_rng(5).integers(0, high + 1, 4)]

    def block():
        took = 0
        for i in range(calls):
            a = time.perf_counter_ns()
            pre.batch(pool[i % 4], top=tops[i % 4])
            took += time.perf_counter_ns() - a
        return took

    return block


def _served(case, device, calls, rate=780.0, pool=64):
    (h, w), crop, _, out, _, _ = case
    pre = Preprocessor(PreprocessConfig(crop_rect=crop, out_size=out), device=device)
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(pool)]
    ex = StreamExecutor(pre, depth=4)

    def block():
        took, t0 = 0, time.perf_counter()
        for i in range(calls):
            while time.perf_counter() < t0 + i / rate:
                pass
            a = time.perf_counter_ns()
            ex.submit(frames[i % pool])
            took += time.perf_counter_ns() - a
        ex.drain()
        return took

    return block


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(name, block, device, calls, rounds):
    """The three kinds of block in turns, ``rounds`` of each."""
    for _ in range(3):  # tables, plans and the allocator's pools made
        block()
    _sync(device)
    took = {m: [] for m in MODES}
    collected = {m: [] for m in MODES}  # (runs, ns) a block
    gcs = _Collections()
    gc.callbacks.append(gcs)
    spans, cost, probe = {}, 0, _Probe()
    probed = {}  # self ns a span name in the probe blocks
    counted = {k: trace.counter(k) for k in _COUNTERS}
    for r in range(rounds):
        for mode in MODES[r % 3:] + MODES[:r % 3]:
            trace.reset()
            if mode != "off":
                trace.enable()
            if mode == "probe":
                config.record_kernel = probe
            runs, ns = gcs.runs, gcs.ns
            try:
                took[mode].append(block() / calls / 1e3)
                _sync(device)
                collected[mode].append((gcs.runs - runs, gcs.ns - ns))
            finally:
                config.record_kernel = probe._count
                trace.disable()
            snap = trace.snapshot()
            if mode == "on":
                cost += snap["cost_ns"]
                for k, v in snap["spans"].items():
                    agg = spans.setdefault(k, [0, 0, 0])
                    agg[0] += v["count"]
                    agg[1] += v["total_ns"]
                    agg[2] += v["self_ns"]
            elif mode == "probe":
                for k, v in snap["spans"].items():
                    probed[k] = probed.get(k, 0) + v["self_ns"]
    counted = {k: trace.counter(k) - v for k, v in counted.items()}
    # the child spans a call, from one more block that keeps its events (whose
    # objects would bring the garbage collector into the timed blocks)
    trace.reset()
    trace.enable()
    trace.keep_events(True)
    try:
        block()
        _sync(device)
    finally:
        trace.keep_events(False)
        trace.disable()
    children = {}
    for e in trace.snapshot()["events"]:
        if e["parent"] is not None:
            children[e["parent"]] = children.get(e["parent"], 0) + 1
    trace.reset()
    gc.callbacks.remove(gcs)
    n = rounds * calls
    residual = statistics.median(probe.residual_ns) if probe.residual_ns else None
    per_span = sum(v[0] for v in spans.values())
    out = {
        "case": name, "device": str(device), "calls": calls, "rounds": rounds,
        "off_us": took["off"], "on_us": took["on"],
        "on_cost_us": statistics.median(b - a for a, b in zip(took["off"], took["on"])),
        "spans": {k: {"per_call": c / n, "total_us": t / n / 1e3, "self_us": s / n / 1e3,
                      "children": children.get(k, 0) / calls,
                      "self_net_us": (s / n - (residual or 0) * children.get(k, 0) / calls) / 1e3,
                      "self_probed_us": probed.get(k, 0) / n / 1e3}
                  for k, (c, t, s) in spans.items()},
        "spans_per_call": per_span / n,
        "tracer_us": cost / n / 1e3,
        "tracer_ns_a_span": cost / per_span if per_span else None,
        "residual_ns": residual,
        "probe_us": took["probe"],
        "probe_site_ns": statistics.median(probe.site_ns) if probe.site_ns else None,
        "probe_marginal_us": statistics.median(b - a for a, b in zip(took["on"], took["probe"])),
        "gc_runs_a_1000": {m: sum(r for r, _ in v) / n * 1000 for m, v in collected.items()},
        "gc_us": {m: sum(t for _, t in v) / n / 1e3 for m, v in collected.items()},
    }
    out["explained_us"] = out["tracer_us"] + (residual or 0) * out["spans_per_call"] / 1e3
    hits, made = counted["pipeline.record_hits"], counted["pipeline.records_made"]
    out["records"] = {"hits": hits, "made": made,
                      "hit_share": hits / (hits + made) if hits + made else None}
    out["per_call"] = {k: counted[k] / n for k in ("tables.made", "native.calls")}
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="small frames on the CPU")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--calls", type=int, default=1000, help="batches a resident block")
    ap.add_argument("--frames", type=int, default=240, help="frames a served block")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.small else "cuda")
    cases = SMALL if args.small else CASES
    results = []
    with config.device(device.type):
        for name in ("config4", "config5"):
            results.append(measure(name, _resident(cases[name], device, args.calls), device,
                                   args.calls, args.rounds))
            print(json.dumps(results[-1]), flush=True)
        results.append(measure("config4.served", _served(cases["config4"], device, args.frames,
                                                         pool=8 if args.small else 64),
                               device, args.frames, args.rounds))
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
