"""Runtime configuration: backend preference and kernel-launch counters.

The PyTorch counterpart of ``vacv_tpu.config``.  There is no platform
probe and no compile cache: a tensor is processed on the device it lies
on, and the CUDA kernels are built on first use (``ops/cuda/build.py``).

Backend preference:

* ``"auto"``: an op takes its fused route where one exists.  On a CUDA
  tensor that route launches the hand-written kernel; on a CPU tensor it
  runs the kernel's plain PyTorch version.
* ``"torch"``: force the chain of plain PyTorch ops (the counterpart of
  the JAX package's ``"jnp"`` backend).
"""
from __future__ import annotations

from contextlib import contextmanager

_VALID = ("auto", "torch")
_BACKEND = "auto"


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}, got {name!r}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def use_fused() -> bool:
    """Should pipelines prefer their fused route?"""
    return _BACKEND == "auto"


@contextmanager
def backend(name: str):
    """Temporarily override the backend preference."""
    global _BACKEND
    prev = _BACKEND
    set_backend(name)
    try:
        yield
    finally:
        _BACKEND = prev


# --- kernel-path observability ------------------------------------
# Counters recording which route actually served each call.  A CUDA
# wrapper records its name once per call that launched its kernel, and
# nowhere else; a plain-PyTorch route records its own name, so tests
# and chip_smoke.py can assert which one ran.
_KERNEL_COUNTS: dict[str, int] = {}


def record_kernel(name: str) -> None:
    _KERNEL_COUNTS[name] = _KERNEL_COUNTS.get(name, 0) + 1


def kernel_count(name: str) -> int:
    return _KERNEL_COUNTS.get(name, 0)


def reset_kernel_counts() -> None:
    _KERNEL_COUNTS.clear()
