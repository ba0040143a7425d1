"""What the harness may load, and that it never runs without a card."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest
import torch

from portbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "vacv_tpu", "bench", "benchmarks", "__graft_entry__"}
MODULES = sorted(p for p in manifest.HERE.rglob("*.py"))


def _imports(path) -> set[str]:
    """Top-level names of every module a file imports (whole names)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(manifest.ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "work.py"):
        assert not _imports(manifest.HERE / name) & {"vacv_tpu_torch", "vacv_tpu"}
    text = (manifest.HERE / "reference.py").read_text()
    assert "from ." not in text


def test_without_a_card_the_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "cfg4.resident",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=manifest.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert "metrics" not in proc.stdout
