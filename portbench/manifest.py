"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names its configuration, whose file the
``configs`` entry gives, and its traffic, ``traffic/<name>.json``.  A
per-layer metric's reader is ``metrics/<name>.py``; it belongs to a cell
when its ``workloads`` list the cell or, without that key, when the cell
reports the end-to-end metric it ``moves``.  A configuration's ``chain``
names ``chains/<chain>.py`` (``crop_resize`` when it names none), and a
traffic's ``loop``, when ``loops.LOOPS`` lacks it, ``loopkinds/<loop>.py``.
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


def module(folder: str, name: str):
    """``<folder>/<name>.py`` of the harness, loaded by its file."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py in {HERE}")
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return module("metrics", name).read


DEFAULT_CHAIN = "crop_resize"


def chain(cfg: dict):
    """The module of a configuration's chain: its inputs, the program and
    the control, the reference, the comparison and the least bytes
    (``chains/crop_resize.py`` lists the names a chain defines)."""
    return module("chains", cfg.get("chain") or DEFAULT_CHAIN)
