"""Small copies of the benchmark's cells for CPU tests: the same chains and
loops at shapes a test run holds, the program on its plain CPU routes."""
from __future__ import annotations

import copy

from portbench import manifest


def small_config(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    if cfg.get("warp"):
        cfg["frame"].update(height=72, width=128)
        cfg["crop"].update(left=4, top=3, width=120, height=66)
        cfg["warp"].update(matrix=[[0.9, 0.03, 2.0], [-0.03, 0.9, 1.25]], width=60, height=34)
    else:
        cfg["frame"].update(height=60, width=80)
        cfg["crop"].update(left=4, top=2, width=64, height=52)
    cfg["out"].update(height=16, width=16)
    return cfg


# A configuration and a traffic of a loop kind that no cell of BENCHMARK.json
# runs yet (the per-card ``sharded`` loop, PERF.md §7), tested as the cells are.
PAIRS = [("cfg5_warp_1440p", "sharded_b2x4")]


def small_cell(name: str):
    """(cell, config, traffic) of a cell of BENCHMARK.json, or of a
    ``<config>.<traffic>`` pair of ``PAIRS``, cut for the CPU: one process
    (a per-card loop runs as a world of one; ``ranked.py`` runs ranks)."""
    bench = manifest.load()
    if name in CELLS:
        cell = dict(manifest.cell(bench, name), chips=1)
    else:
        config, traffic_name = name.split(".", 1)
        cell = {"name": name, "config": config, "traffic": traffic_name, "chips": 1}
    cfg = small_config(manifest.config(bench, cell))
    traffic = dict(manifest.traffic(cell))
    traffic.update(sample_gap=3, pool=min(traffic["pool"], 4), sample_share=0.5,
                   batch=min(traffic.get("batch", 4), 4))
    if traffic["loop"] == "served":
        traffic["cameras"] = 4
    return cell, cfg, traffic


CELLS = [w["name"] for w in manifest.load()["workloads"]]
CASES = CELLS + [f"{c}.{t}" for c, t in PAIRS]  # what the CPU tests run
