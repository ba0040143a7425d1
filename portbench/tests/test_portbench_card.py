"""A short run of each cell on the cards (skips without as many cards as
the cell asks for)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import manifest


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_a_short_run_is_correct_on_the_card(cell):
    chips = manifest.cell(manifest.load(), cell)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                           "--seed", "4242", "--seconds", "1", "--trace", "0"],
                          cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"] is True, line["checks"]
