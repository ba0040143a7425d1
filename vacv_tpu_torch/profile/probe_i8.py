"""Probe of the card's tensor-core rates: bf16 → f32 against int8 → int32.

The counterpart of ``benchmarks/probe_i8.py``, with its three sections and
shapes: bf16 and int8 at M=96, K=128, N=2048, reps=64 (checked against the
probe's reference expression); an int8 K sweep K ∈ {32, 64, 96, 128} at
N=1024; and bf16 and int8 at 1024³, reps=32.  Each case runs the
hand-written tensor-core kernel through ``ops/cuda/probe.py::probe_dot``
and times it with ``utils/perf.device_time``; beside it the script prints
the rate, its share of the card's dense peak (H100 SXM data sheet: 989
TFLOP/s bf16, 1979 TOPS int8) and the time of one library call for the
same work (``torch.matmul`` in bf16, ``torch._int_mm`` in int8, on the
windows laid side by side as one (M, reps·K) × (reps·K, N) product), which
is a yardstick only.  At the small shapes a call is microseconds of work,
so the probe measures launch and tail there; the 1024³ case is the
honest rate.

Run on the card:  python -m vacv_tpu_torch.profile.probe_i8
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from .. import config
from ..ops.cuda.probe import probe_dot, probe_dot_torch
from ..utils.perf import device_time

PEAK_OPS = {torch.bfloat16: 989e12, torch.int8: 1979e12}  # H100 SXM, dense


def operands(rng: np.random.Generator, m: int, k: int, n: int, reps: int, dtype, device):
    """The probe's integer operands (a in [-100, 100), b in [-2, 3), as
    benchmarks/probe_i8.py:63-65): a2 of M + reps + 1 rows, whose one-row
    windows ``a2[i % 2 :][: M + reps]`` the timed steps slide over, and b."""
    a2 = torch.from_numpy(rng.integers(-100, 100, (m + reps + 1, k)))
    b = torch.from_numpy(rng.integers(-2, 3, (k, n)))
    return a2.to(device=device, dtype=dtype), b.to(device=device, dtype=dtype)


def step(i: int, a2: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """One probe call on the window shifted by ``i % 2`` (the anti-hoist
    contract of ``utils/perf.device_time``)."""
    return probe_dot(a2[i % 2 : i % 2 + a2.shape[0] - 1], b, reps)


def library_operands(a: torch.Tensor, b: torch.Tensor, reps: int):
    """The same work as one product: the reps windows of a side by side,
    (M, reps·K), against b stacked reps times, (reps·K, N)."""
    m = a.shape[0] - reps
    wide = torch.cat([a[r : r + m] for r in range(reps)], dim=1).contiguous()
    return wide, b.repeat(reps, 1).contiguous()


def library_call(wide: torch.Tensor, tall: torch.Tensor) -> torch.Tensor:
    """One PyTorch call for the same function: ``torch._int_mm`` for int8,
    ``torch.matmul`` (f32 accumulation, bf16 result) for bf16."""
    if wide.dtype == torch.int8:
        return torch._int_mm(wide, tall)
    return torch.matmul(wide, tall)


def card() -> str:
    """The card's ``nvidia-smi`` name and power limit, or torch's name."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def run_case(label: str, m: int, k: int, n: int, reps: int, dtype, rng, device, *,
             check: bool = False, where: str = "") -> dict:
    """Time one probe shape (and, with ``check``, hold the result to
    ``probe_dot_torch`` bit for bit); print and return its numbers."""
    a2, b = operands(rng, m, k, n, reps, dtype, device)
    ok = None
    if check:
        ok = torch.equal(probe_dot(a2[:-1], b, reps), probe_dot_torch(a2[:-1], b, reps))
    sec = device_time(step, a2, b, reps)
    wide, tall = library_operands(a2[:-1], b, reps)
    lib_sec = device_time(lambda i, x, y: library_call(x, y), wide, tall)
    ops = 2 * m * k * n * reps
    rate = ops / sec
    res = dict(label=label, m=m, k=k, n=n, reps=reps, dtype=str(dtype).split(".")[-1], ok=ok,
               us=sec * 1e6, rate=rate, peak_share=rate / PEAK_OPS[dtype],
               bound_us=ops / PEAK_OPS[dtype] * 1e6, library_us=lib_sec * 1e6)
    unit = "TOPS" if dtype == torch.int8 else "TFLOP/s"
    # A share of the card's peak only for a run on the card.
    share = (f" = {100 * res['peak_share']:.2f}% of {PEAK_OPS[dtype] * 1e-12:.0f} "
             f"(bound {res['bound_us']:.2f} us)" if a2.device.type == "cuda" else "")
    print(f"{label}: {'' if ok is None else f'ok={ok}  '}{res['us']:.2f} us  "
          f"{rate * 1e-12:.3f} {unit}{share}; library {res['library_us']:.2f} us {where}",
          flush=True)
    return res


def main(device=None) -> list[dict]:
    """The probe's three sections on ``device`` (default: the card)."""
    device = config.input_device(device)
    rng = np.random.default_rng(0)
    where = f"[{card()}]" if device.type == "cuda" else "[cpu]"
    results = []
    for name, dt in (("bf16->f32", torch.bfloat16), ("i8->i32", torch.int8)):
        results.append(run_case(name, 96, 128, 2048, 64, dt, rng, device, check=True,
                                where=where))
    # K sweep at the warp kernel's dot shape: does a narrower contraction
    # cost less?
    for k in (32, 64, 96, 128):
        results.append(run_case(f"i8 K={k}", 96, k, 1024, 64, torch.int8, rng, device,
                                where=where))
    # Larger, tensor-core-saturating shapes for an honest peak comparison.
    for name, dt in (("bf16 1024^3", torch.bfloat16), ("i8 1024^3", torch.int8)):
        results.append(run_case(name, 1024, 1024, 1024, 32, dt, rng, device, where=where))
    return results


if __name__ == "__main__":
    main()
