"""Readings behind a cell's limits: the program's numbers over many seeds,
and the control's.

    python3 -m portbench.calibrate --workload cfg4.resident --seeds 1,2,3 --seconds 3 [--control]

Runs the cell's loop for ``--seconds`` at its own load and size once for
each seed, in one process, and prints one JSON line a seed with the numbers
the check compares, then a last line with the largest reading of each
number over the seeds.  With
``--control`` the control (``systems.Control``: the reference in bfloat16)
takes the program's place; its smallest reading of a number is the upper
end of that number's limit, the program's largest the lower end
(``PERF.md`` gives both and the limit chosen).  The benchmark's own runs do
not run the control.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from . import manifest, run

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    cfg, traffic = manifest.config(bench, cell), manifest.traffic(cell)
    run.require_cards(cell["chips"])
    system = "control" if args.control else "program"
    seeds = [int(s) for s in args.seeds.split(",")]
    results = [run.execute(cell, cfg, traffic, s, args.seconds, False, "cuda", system)
               for s in seeds]
    worst, best = {}, {}
    for seed, (r, numbers) in zip(seeds, results):
        print(json.dumps({"seed": seed, "system": system, "numbers": numbers,
                          "outputs": len(r.samples), "frames": r.attempted}), flush=True)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, v), v)
            best[k] = min(best.get(k, v), v)
    print(json.dumps({"system": system, "seeds": len(seeds), "largest": worst,
                      "smallest": best}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
