"""vacv_tpu_torch.utils.perf against vacv_tpu.utils.perf.

The scope timers and ``time_fn`` keep the JAX module's contracts on the
same host functions; ``device_time`` keeps the ``step_fn(i, *args)``
contract and the loop slope (on CPU tensors it times with
``perf_counter``; the CUDA-event branch runs on the card, in
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""
import json
import time

import numpy as np
import pytest
import torch

from vacv_tpu.utils import perf as jperf
from vacv_tpu_torch import config
from vacv_tpu_torch.utils import perf


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


@pytest.mark.parametrize("mod", [jperf, perf], ids=["jax", "torch"])
def test_timer_accumulates_and_time_perf_writes_its_key(mod):
    t = mod.Timer()
    for _ in range(2):
        with t.scope():
            time.sleep(0.002)
    assert t.ms >= 4.0
    out = {}
    with mod.time_perf(out, "step"):
        time.sleep(0.002)
    assert set(out) == {"step"} and out["step"] >= 2.0


def test_time_perf_writes_on_an_exception_too():
    out = {}
    with pytest.raises(RuntimeError):
        with perf.time_perf(out):
            raise RuntimeError("boom")
    assert out["ms"] >= 0.0


def test_time_fn_contract_matches_jax():
    """(best_ms, mean_ms, last_result): best <= mean, the result is the
    function's, warm-up calls are not timed."""
    calls = {"jax": 0, "torch": 0}

    def fn(which, x):
        calls[which] += 1
        return x * 2

    x = np.arange(6, dtype=np.float32)
    jb, jm, jr = jperf.time_fn(fn, "jax", x, iters=4, warmup=3)
    tb, tm, tr = perf.time_fn(fn, "torch", torch.from_numpy(x), iters=4, warmup=3)
    assert calls == {"jax": 7, "torch": 7}
    assert 0 <= jb <= jm and 0 <= tb <= tm
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


def test_device_time_calls_both_parities_and_returns_a_positive_slope():
    seen = []
    x = torch.arange(4096, dtype=torch.float32)

    def step(i, x, scale):
        seen.append(i)
        return (x[i % 2 :] * scale).sum()

    sec = perf.device_time(step, x, 3.0, iters=8, base_iters=2)
    assert sec > 0 and np.isfinite(sec)
    assert {0, 1} <= {i % 2 for i in seen}
    assert max(seen) >= 7  # the large sample ran all its iterations


def test_device_time_slope_tracks_the_work():
    """A step that sleeps 2 ms reads near 2 ms: the slope cancels the
    constant and keeps the per-iteration cost."""
    sec = perf.device_time(lambda i: time.sleep(0.002), iters=6, base_iters=2)
    assert 0.0015 < sec < 0.02


def test_on_card_reads_tensors_and_tuples():
    t = torch.zeros(2)
    assert not perf._on_card(t) and not perf._on_card((t, [t])) and not perf._on_card(3.0)
    meta = torch.empty(2, device="meta")
    assert not perf._on_card(meta)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with perf.profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    trace = tmp_path / "trace" / "trace.json"
    assert trace.exists()
    assert "traceEvents" in json.loads(trace.read_text())
    assert len(prof.key_averages()) > 0
