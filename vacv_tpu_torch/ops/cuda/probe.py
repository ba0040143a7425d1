"""The tensor-core probe: a sum of row-shifted matrix products.

The counterpart of ``benchmarks/probe_i8.py::_mk``, the TPU probe of the
MXU's bf16 and int8 rates.  ``probe_dot(a, b, reps)`` takes a (M + reps, K)
and b (K, N) and returns

    out = Σ_{r < reps} a[r : r + M] @ b

in float32 for bf16 operands and int32 for int8 ones: ``reps`` products on
distinct row windows of A, so that no compiler or kernel can fold them into
one.  On a CUDA tensor it launches the hand-written tensor-core kernel
(``vacv_tpu_torch/csrc/probe_mma.cu``), counted as ``"probe_dot"``, or
raises; on a CPU tensor it runs the plain version ``probe_dot_torch``,
counted as ``"probe_dot_torch"``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import config
from . import build

# operand type → (result type, K granule of one mma step)
_TYPES = {torch.bfloat16: (torch.float32, 16), torch.int8: (torch.int32, 32)}


@functools.lru_cache(maxsize=1)
def _entry_points():
    lib = build.library().lib
    i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    fn = lib.vacv_probe_mma
    fn.restype = i
    # device, stream, a, lda, b, ldb, out, m, k, n, reps, is_i8
    fn.argtypes = [i, p, p, ll, p, ll, p, i, i, i, i, i]
    return lib, fn


def _check(a, b, reps: int) -> int:
    """Raise ValueError for operands the probe does not take; returns M."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"probe_dot needs 2-D operands, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _TYPES:
        raise ValueError(f"probe_dot takes two bf16 or two int8 operands, got {a.dtype} and {b.dtype}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"a is (M + reps, {a.shape[1]}) but b has {b.shape[0]} rows")
    if int(reps) < 1 or a.shape[0] - int(reps) < 1:
        raise ValueError(f"a must have M + reps rows with M >= 1 and reps >= 1, got "
                         f"{a.shape[0]} rows for reps={reps}")
    if a.device != b.device:
        raise ValueError("a and b lie on different devices")
    return a.shape[0] - int(reps)


def probe_dot_torch(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain PyTorch version: the probe's reference expression
    ``Σ_r a[r:r+M] @ b`` in float64, cast to float32 (bf16) or int32
    (int8, through int64 so a sum past 2³¹ wraps as the kernel's s32 does).
    Runs on any device."""
    m = _check(a, b, reps)
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    acc = sum(a64[r : r + m] @ b64 for r in range(int(reps)))
    if a.dtype == torch.int8:
        return acc.to(torch.int64).to(torch.int32)
    return acc.to(torch.float32)


def _launch(a, b, reps, m):
    out_dtype, granule = _TYPES[a.dtype]
    k, n = b.shape
    if k % granule:
        raise ValueError(f"the probe kernel needs K a multiple of {granule} for {a.dtype}, got {k}")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("the probe kernel needs operands with contiguous rows")
    if (a.stride(0) * a.element_size()) % 16 or a.data_ptr() % 16:
        raise ValueError("the probe kernel needs 16-byte aligned rows of a")
    dev = a.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    lib, fn = _entry_points()
    rc = fn(dev.index, torch.cuda.current_stream(dev).cuda_stream, a.data_ptr(), a.stride(0),
            b.data_ptr(), b.stride(0), out.data_ptr(), m, k, n, int(reps),
            int(a.dtype == torch.int8))
    build.check(lib, rc, "probe kernel")
    config.record_kernel("probe_dot")
    return out


def probe_dot(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """``Σ_{r < reps} a[r : r + M] @ b`` for a (M + reps, K) and b (K, N):
    bf16 → float32 or int8 → int32.

    Raises ValueError for operands the kernel does not take (other types,
    a row count below reps + 1, K not a multiple of 16 for bf16 or 32 for
    int8, rows that are not contiguous or, for a, not 16-byte aligned)."""
    m = _check(a, b, reps)
    if a.device.type == "cuda":
        return _launch(a, b, reps, m)
    if a.device.type != "cpu":
        raise ValueError(f"no probe route for device {a.device}")
    out = probe_dot_torch(a, b, reps)
    config.record_kernel("probe_dot_torch")
    return out
