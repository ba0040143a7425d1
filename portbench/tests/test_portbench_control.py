"""The control (the reference in bfloat16, in the program's place) comes out
not correct, and the program correct, in every cell's loop at a test's size."""
from __future__ import annotations

import pytest

from portbench import check, run
from portbench.tests.helpers import CASES, small_cell

SEEDS = (2**31 + 5, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CASES)
def test_control_fails_and_program_passes(name, seed):
    cell, cfg, traffic = small_cell(name)
    for system, want in (("program", True), ("control", False)):
        r, numbers = run.execute(cell, cfg, traffic, seed, 0.3, False, "cpu", system)
        ok, checks = check.verdict(numbers, check.limits(cfg, traffic), r.failed)
        assert ok is want, (system, checks)
