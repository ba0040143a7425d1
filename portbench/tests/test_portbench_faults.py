"""A run with the timed path broken underneath comes out not correct: the
harness drives a whole run (its look for a card skipped, the program on its
CPU routes) with each fault a cell can have planted in the program."""
from __future__ import annotations

import importlib

import pytest

from portbench import check, run, systems
from portbench.tests import faults
from portbench.tests.helpers import CELLS, small_cell

CASES = [(c, f) for c in CELLS for f in faults.FAULTS]


@pytest.fixture
def clean():
    yield
    importlib.reload(systems)


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(name, fault, clean):
    cell, cfg, traffic = small_cell(name)
    faults.plant(fault)
    r, numbers = run.execute(cell, cfg, traffic, 2**31 + 77, 0.3, False, "cpu")
    ok, checks = check.verdict(numbers, cfg["limits"], r.failed)
    assert not ok, checks
