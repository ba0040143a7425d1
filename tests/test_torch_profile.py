"""vacv_tpu_torch.profile (CvProfile) against vacv_tpu.profile.

The same deterministic test functions go through both runners: the
averaged results, the pass/fail verdicts, the printed table and the
``save_results`` JSON must be equal.
"""
import json

import pytest

from vacv_tpu import profile as jprofile
from vacv_tpu_torch import config
from vacv_tpu_torch import profile as tprofile
from vacv_tpu_torch.utils.compare import MAX_DIFF


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


def make_tests(mod, log):
    """Deterministic tests: one passing, one failing by half the bar over
    it, one slower than the reference, one whose values vary per run."""
    counter = {"n": 0}

    def varying():
        counter["n"] += 1
        return (1.0 + counter["n"], 0.5 * counter["n"], 1 - 1e-5 * counter["n"], 1.0)

    return [
        mod.TestFuncInfo("pass", lambda: (4.0, 1.0, 1.0 - 5e-5, 1.0),
                         setup=lambda: log.append("setup"), clean=lambda: log.append("clean")),
        mod.TestFuncInfo("fail", lambda: (2.0, 1.0, 1.0 - 1.5e-4, 1.0)),
        mod.TestFuncInfo("at_bar", lambda: (1.0, 2.0, 1.0 - MAX_DIFF / 2, 1.0)),
        mod.TestFuncInfo("varying", varying),
    ]


def run(mod, capsys, tmp_path, name):
    log = []
    prof = mod.CvProfile(k_test_times=4, k_log_batch_size=2)
    results = prof.profile(make_tests(mod, log), verbose=True)
    ok = prof.print_results()
    out = capsys.readouterr().out
    path = tmp_path / f"{name}.json"
    prof.save_results(str(path))
    return results, ok, out, json.loads(path.read_text()), log


def test_cvprofile_matches_jax(capsys, tmp_path):
    j = run(jprofile, capsys, tmp_path, "jax")
    t = run(tprofile, capsys, tmp_path, "torch")
    jres, tres = j[0], t[0]
    assert [vars(r) for r in jres] == [vars(r) for r in tres]
    assert [r.passed for r in tres] == [True, False, True, True]
    assert [r.speedup for r in jres] == [r.speedup for r in tres]
    assert j[1] == t[1] is False
    # The table and the progress lines, except the wall-clock "done in" lines.
    strip = lambda s: [ln for ln in s.splitlines() if "done in" not in ln]  # noqa: E731
    assert strip(j[2]) == strip(t[2])
    assert j[3] == t[3] and [row["passed"] for row in t[3]] == [True, False, True, True]
    assert j[4] == t[4] == ["setup", "clean"] * 4


def test_max_diff_and_zero_time():
    assert tprofile.CvProfile().max_diff == jprofile.CvProfile().max_diff == MAX_DIFF
    r = tprofile.TestResult("z", 1.0, 0.0, 1.0, 1.0, 1)
    assert r.speedup == float("inf") and r.passed
