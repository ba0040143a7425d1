"""BENCHMARK.json against the benchmark's contract, and every file it names."""
from __future__ import annotations

import json
import re

import pytest

from portbench import loops, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metrics_sources_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert manifest.reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_layers_are_named_in_perf_md():
    perf = (manifest.ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"**{m['layer']}**" in perf, m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = manifest.cell(BENCH, cell)
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4)
    cfg = manifest.config(BENCH, w)
    traffic = manifest.traffic(w)
    assert callable(loops.find(traffic["loop"]).run)
    assert set(cfg["limits"]) >= {"max_err_lsb", "off_share"}
    e2e = manifest.end_to_end(BENCH, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = manifest.per_layer(BENCH, cell)
    assert layer
    for m in e2e + layer:
        assert callable(manifest.reader(m["name"]))


def test_configs_used_and_unreduced():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert c["reduced"] == []
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == [] and cfg["assumed"] == []


def test_pairs_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("path", sorted((manifest.HERE / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_traffic_names_a_loop_that_is_found(path):
    loop = loops.find(json.loads(path.read_text())["loop"])
    assert callable(loop.run)


@pytest.mark.parametrize("path", sorted((manifest.HERE / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_config_names_a_chain_that_is_found(path):
    chain = manifest.chain(json.loads(path.read_text()))
    for name in ("frames", "tops", "system", "reference", "compare", "chain_bytes"):
        assert callable(getattr(chain, name)), name
