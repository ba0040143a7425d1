"""Find the knee of a served cell: its open loop at several offered rates.

    python3 -m portbench.sweep --workload cfg4.served --cameras 30,40,50 --seconds 10 --seed 1

Runs the cell's ``served`` loop once for each camera count, in one process,
and prints one JSON line a rate: the offered rate, the share of frames
complete inside the window, how late the generator was over the last tenth
of the window, the latency percentiles (all frames, and the 95th in each
second) and the mean ``submit`` span.  The knee is the highest rate at
which the backlog does not grow (over the last tenth of the window the
generator's median lateness is under ``LATE_S``; one host stall there does
not move it) and at least 99% of the offered frames complete in the
window.  The cell's own rate is then set at four fifths of it.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

LATE_S = 5e-3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--cameras", required=True, help="comma-separated camera counts")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from vacv_tpu_torch import config

    from . import loops, manifest, systems
    from .run import require_cards
    from .stats import percentile

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    cfg, traffic = manifest.config(bench, cell), manifest.traffic(cell)
    require_cards(1)
    sut = systems.build("program", cfg, "cuda")
    knee = None
    for cams in (int(c) for c in args.cameras.split(",")):
        t = dict(traffic, cameras=cams, trace_items=0)
        with config.device("cuda"):
            run = loops.served(sut, cfg, t, args.seed, args.seconds, True, "cuda")
        lat = np.array(run.latency_s)  # in arrival order
        tail = run.late_s[int(0.9 * len(run.late_s)):]
        per_s = []
        n = len(lat)
        for k in range(int(args.seconds)):
            part = lat[int(k * n / args.seconds):int((k + 1) * n / args.seconds)]
            per_s.append(round(percentile(part, 95) * 1e3, 3) if len(part) else None)
        sub = run.trace["spans"].get("serve.submit", (0, 0.0))
        row = {
            "threads": torch.get_num_threads(), "cameras": cams, "offered_fps": cams * t["fps"],
            "complete_share": run.completed / run.attempted,
            "late_tail_p50_ms": percentile(tail, 50) * 1e3,
            "late_tail_p95_ms": percentile(tail, 95) * 1e3,
            "latency_p50_ms": percentile(lat, 50) * 1e3,
            "latency_p95_ms": percentile(lat, 95) * 1e3,
            "latency_p99_ms": percentile(lat, 99) * 1e3,
            "latency_max_ms": float(lat.max()) * 1e3,
            "p95_by_second_ms": per_s,
            "submit_us": sub[1] / sub[0] * 1e6 if sub[0] else None,
        }
        row["sustained"] = row["late_tail_p50_ms"] < LATE_S * 1e3 and row["complete_share"] >= 0.99
        if row["sustained"]:
            knee = row["offered_fps"]
        print(json.dumps(row), flush=True)
        del run
        torch.cuda.synchronize()
    print(json.dumps({"knee_fps": knee, "rate_at_four_fifths": None if knee is None
                      else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
