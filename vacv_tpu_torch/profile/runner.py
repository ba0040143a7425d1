"""CvProfile-style differential benchmark runner.

A copy of ``vacv_tpu/profile/runner.py`` for the port (that module
imports no JAX, but the port imports nothing of the JAX package), itself
the rebuild of the reference test/profile harness
(``src/test/src/profile/cv_profile.{h,cpp}``): each registered test
returns the four-tuple ``[ref_ms, ours_ms, cosine, expected]``
(cv_profile.h:20-24); the runner repeats every test ``k_test_times``
times, logs batch averages every ``k_log_batch_size`` iterations, and
prints a final PASS/FAIL table.  The pass bar is 1e-4 (the reference's
is 5e-4), and ``save_results`` writes JSON (a stub in the reference,
cv_profile.cpp:119-121).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..utils.compare import MAX_DIFF

_GREEN = "\033[32m"
_RED = "\033[31m"
_RESET = "\033[0m"

# TestFunc: () -> (ref_ms, ours_ms, cosine, expected)
TestFunc = Callable[[], Sequence[float]]


@dataclass
class TestFuncInfo:
    name: str
    func: TestFunc
    setup: Callable[[], None] | None = None
    clean: Callable[[], None] | None = None


@dataclass
class TestResult:
    name: str
    ref_ms: float
    ours_ms: float
    cosine: float
    expected: float
    runs: int

    @property
    def passed(self) -> bool:
        return abs(self.cosine - self.expected) <= MAX_DIFF

    @property
    def speedup(self) -> float:
        return self.ref_ms / self.ours_ms if self.ours_ms > 0 else float("inf")


@dataclass
class CvProfile:
    """Aggregate runner; mirrors ``CvProfile::profile``."""

    k_test_times: int = 10
    k_log_batch_size: int = 5
    max_diff: float = MAX_DIFF
    results: list[TestResult] = field(default_factory=list)

    def profile(self, tests: Sequence[TestFuncInfo], verbose: bool = True) -> list[TestResult]:
        for info in tests:
            sums = [0.0, 0.0, 0.0, 0.0]
            t_start = time.perf_counter()
            for i in range(self.k_test_times):
                if info.setup is not None:
                    info.setup()
                vals = info.func()
                if info.clean is not None:
                    info.clean()
                for k in range(4):
                    sums[k] += float(vals[k])
                if verbose and (i + 1) % self.k_log_batch_size == 0:
                    n = i + 1
                    print(
                        f"  [{info.name}] {n}/{self.k_test_times}: "
                        f"ref={sums[0]/n:.3f}ms ours={sums[1]/n:.3f}ms "
                        f"cos={sums[2]/n:.6f}"
                    )
            n = self.k_test_times
            res = TestResult(
                name=info.name,
                ref_ms=sums[0] / n,
                ours_ms=sums[1] / n,
                cosine=sums[2] / n,
                expected=sums[3] / n,
                runs=n,
            )
            self.results.append(res)
            if verbose:
                elapsed = time.perf_counter() - t_start
                print(f"  [{info.name}] done in {elapsed:.2f}s")
        return self.results

    def print_results(self) -> bool:
        """Final table; returns overall pass/fail."""
        all_pass = True
        name_w = max((len(r.name) for r in self.results), default=10) + 2
        print(
            f"{'test':<{name_w}} {'ref_ms':>10} {'ours_ms':>10} "
            f"{'speedup':>8} {'cosine':>10}  result"
        )
        for r in self.results:
            ok = r.passed
            all_pass &= ok
            tag = f"{_GREEN}PASS{_RESET}" if ok else f"{_RED}FAIL{_RESET}"
            print(
                f"{r.name:<{name_w}} {r.ref_ms:>10.3f} {r.ours_ms:>10.3f} "
                f"{r.speedup:>7.1f}x {r.cosine:>10.6f}  {tag}"
            )
        return all_pass

    def save_results(self, path: str) -> None:
        """JSON dump (the reference left this as a todo)."""
        payload = [
            {
                "name": r.name,
                "ref_ms": r.ref_ms,
                "ours_ms": r.ours_ms,
                "speedup": r.speedup,
                "cosine": r.cosine,
                "expected": r.expected,
                "runs": r.runs,
                "passed": r.passed,
            }
            for r in self.results
        ]
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
