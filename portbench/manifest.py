"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names its configuration, whose file the
``configs`` entry gives, and its traffic, ``traffic/<name>.json``.  A
per-layer metric's reader is ``metrics/<name>.py``; it belongs to a cell
when its ``workloads`` list the cell or, without that key, when the cell
reports the end-to-end metric it ``moves``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, cell: dict, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")


def traffic(cell: dict) -> dict:
    return json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())


def reports(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if reports(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e)]


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
