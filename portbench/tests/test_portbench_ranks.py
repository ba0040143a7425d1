"""The rank launcher on the CPU: two gloo ranks of a per-card loop at a
small size come out correct, the same run with the exchange left out comes
out not correct, and a rank that exits early ends the run with exit 1 and
no result line."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import loops, manifest
from portbench.tests.helpers import PAIRS

# Every (config, traffic) whose loop runs one process a card.
CELLS = [f"{c}.{t}" for c, t in PAIRS
         if getattr(loops.find(manifest.traffic({"traffic": t})["loop"]), "PER_CARD", False)]
TIMEOUT_S = 60


def ranked(cell: str, fault: str, seed: int) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "portbench.tests.ranked", "--pair", cell,
                           "--ranks", "2", "--seed", str(seed), "--seconds", "1",
                           "--device", "cpu", "--small", "--fault", fault],
                          cwd=manifest.ROOT, capture_output=True, text=True, timeout=TIMEOUT_S)


def result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_two_gloo_ranks_are_correct(cell):
    line = result(ranked(cell, "none", 2**31 + 91))
    assert line["correct"] is True, line["checks"]
    assert [r["steps"] for r in line["ranks"]] == [line["ranks"][0]["steps"]] * 2
    assert line["attempted"] == line["ranks"][0]["steps"] * 2 * 2


@pytest.mark.parametrize("cell", CELLS)
def test_the_exchange_left_out_is_not_correct(cell):
    line = result(ranked(cell, "exchange", 2**31 + 92))
    assert line["correct"] is False
    assert line["checks"]["stat_rel_err"]["value"] > line["checks"]["stat_rel_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_rank_that_exits_early_ends_the_run_without_a_result(cell):
    proc = ranked(cell, "rank_exits", 2**31 + 93)
    assert proc.returncode == 1
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
