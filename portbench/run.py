"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It drives ``vacv_tpu_torch`` on the CUDA cards of this machine, and fails
(exit 1, no result) when there are fewer cards than the cell asks for: it
never falls back to the CPU.  With ``--trace 0`` the result's metrics are the
cell's end-to-end ones, with ``--trace 1`` its per-layer ones (``README.md``).
The last line of standard output is one JSON object; the numbers the check
compared close standard error and the result line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "vacv_tpu")


def process_start_epoch() -> float:
    """When this process started, on the ``time.time()`` clock."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    return time.time() - age


STARTED = process_start_epoch()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"portbench: the cell needs {chips} CUDA card(s), "
                         f"torch sees {count}; no result")


class Result:
    """A run as the metric readers see it."""

    def __init__(self, run, cfg: dict, traffic: dict, kind: str, setup_s: float):
        self.run, self.cfg, self.traffic, self.kind, self.setup_s = run, cfg, traffic, kind, setup_s
        self.trace = run.trace


def execute(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
            device="cuda", system: str = "program"):
    """(Run, numbers compared) of one run of a cell: the loop its traffic
    names, then the check.  The peak memory is read before the reference
    runs; ``run.peak_bytes`` holds it."""
    import torch

    from . import check, loops, systems

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    from vacv_tpu_torch import config

    sut = systems.build(system, cfg, device)
    with config.device(torch.device(device).type):  # where the host frames go
        run = loops.LOOPS[traffic["loop"]](sut, cfg, traffic, seed, seconds, trace, device)
    run.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    del sut
    numbers = check.compare(run.samples, run.pool, cfg, device)
    return run, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import check, manifest

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    cfg, traffic = manifest.config(bench, cell), manifest.traffic(cell)
    require_cards(cell["chips"])
    import torch

    run, numbers = execute(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace))
    check_s = time.time() - run.start_epoch - run.elapsed_s
    kind = torch.cuda.get_device_name(0)
    correct, checks = check.verdict(numbers, cfg["limits"], run.failed)
    result = Result(run, cfg, traffic, kind, run.start_epoch - STARTED)
    wanted = manifest.per_layer(bench, cell["name"]) if args.trace else \
        manifest.end_to_end(bench, cell["name"])
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"])(result)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": int(run.peak_bytes)}
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    t = run.trace and run.trace["timeline"]
    if args.trace and t:
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        line["breakdown"] = {
            "device_ops": sorted(t["ops"].items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(t["idle"].items(), key=lambda kv: -kv[1])[:10],
        }
        line["trace_counts"] = {k: t[k] for k in ("span_counts", "device_events",
                                                   "launched_in_spans", "profiler_start_s")}
    line["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 1
    print(f"portbench: {run.attempted} frames attempted, {run.completed} completed in the "
          f"window, {len(run.latency_s) or run.steps} samples, "
          f"{len(run.samples)} outputs checked in {check_s:.2f} s after the window, "
          f"device peak {int(run.peak_bytes)} bytes")
    if run.latency_s:
        from .stats import percentile
        print("portbench: latency ms p50/p90/p95/p99 " + " ".join(
            f"{percentile(run.latency_s, q) * 1e3:.3f}" for q in (50, 90, 95, 99)))
    print(json.dumps(line), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
