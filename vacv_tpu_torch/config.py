"""Runtime configuration: default device, backend preference and
kernel-launch counters.

The PyTorch counterpart of ``vacv_tpu.config``.  There is no compile
cache: the CUDA kernels are built on first use (``ops/cuda/build.py``).

Device: a tensor is processed on the device it lies on.  A numpy input
goes to ``default_device()``, which is ``"cuda"`` (the card, as
``jnp.asarray`` puts it on the accelerator) unless the caller asked for
the CPU with ``set_default_device("cpu")`` or a ``device("cpu")``
context.  With no card and no such request, ``input_device()`` raises.

Backend preference:

* ``"auto"``: an op takes its fused route where one exists.  On a CUDA
  tensor that route launches the hand-written kernel; on a CPU tensor it
  runs the kernel's plain PyTorch version.
* ``"torch"``: force the chain of plain PyTorch ops (the counterpart of
  the JAX package's ``"jnp"`` backend).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

_VALID = ("auto", "torch")
_BACKEND = "auto"
_DEVICES = ("cuda", "cpu")
_DEVICE = "cuda"


def set_default_device(name: str) -> None:
    global _DEVICE
    if name not in _DEVICES:
        raise ValueError(f"default device must be one of {_DEVICES}, got {name!r}")
    _DEVICE = name


def default_device() -> str:
    """Where a numpy input goes: ``"cuda"`` unless the CPU was asked for."""
    return _DEVICE


@contextmanager
def device(name: str):
    """Temporarily override the default device."""
    global _DEVICE
    prev = _DEVICE
    set_default_device(name)
    try:
        yield
    finally:
        _DEVICE = prev


def input_device(requested=None):
    """The ``torch.device`` a numpy input goes to: ``requested`` if given,
    else ``default_device()``.  Raises RuntimeError for the card when
    PyTorch sees none: nothing falls back to the CPU unasked."""
    dev = torch.device(requested if requested is not None else _DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vacv_tpu_torch puts numpy inputs on the CUDA card by default, and "
            "torch.cuda.is_available() is false: ask for the CPU with "
            'vacv_tpu_torch.config.device("cpu") (a context) or '
            'config.set_default_device("cpu")'
        )
    return dev


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
