"""A per-card cell run over ranks as ``run.py`` runs it, with a fault of a
per-card run planted in every rank (``faults.plant_rank``), for the rank
tests and for reading a fault on the cards:

    python3 -m portbench.tests.ranked --pair cfg5_warp_1440p.sharded_b2x4 --ranks 2 \\
        --seed 7 --seconds 1 --device cpu --small [--fault exchange]

This process is rank 0; the launcher starts the others as ``run.py``'s
does, or, with a fault, as ``python3 -m portbench.tests.ranked --fault
<fault> --child <spec>``.  The
last line of standard output is ``{"correct", "attempted", "failed",
"ranks", "checks"}``; a run that fails prints none and exits 1.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(prog="python3 -m portbench.tests.ranked")
    ap.add_argument("--fault", default="none")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--pair", default="cfg5_warp_1440p.sharded_b2x4",
                    help="<config>.<traffic>, or a cell of BENCHMARK.json")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--small", action="store_true")
    args, rest = ap.parse_known_args(argv)

    from portbench import check, manifest, ranks
    from portbench.tests import faults

    if args.child:
        spec = json.loads(rest[-1])
        if args.fault != "none":
            faults.plant_rank(args.fault, spec["rank"])
        return ranks.child(spec)
    if args.fault != "none":
        faults.plant_rank(args.fault, 0)
    if args.small:
        from portbench.tests.helpers import small_cell

        _, cfg, traffic = small_cell(args.pair)
    else:
        config, traffic_name = args.pair.split(".", 1)
        cfg = manifest.config(manifest.load(), {"config": config})
        traffic = manifest.traffic({"traffic": traffic_name})
    child = None if args.fault == "none" else \
        [sys.executable, "-m", "portbench.tests.ranked", "--fault", args.fault, "--child"]
    run, numbers = ranks.launch(args.ranks, cfg, traffic, args.seed, args.seconds, False,
                                args.device, child=child)
    correct, checks = check.verdict(numbers, check.limits(cfg, traffic), run.failed)
    print(json.dumps({"correct": correct, "attempted": run.attempted, "failed": run.failed,
                      "ranks": run.extra["ranks"], "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
