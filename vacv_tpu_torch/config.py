"""Runtime configuration: default device, backend preference and the
counters of the routes that served each call.

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

The starting preference comes from the ``VACV_BACKEND`` environment
variable, read once at import as ``vacv_tpu.config`` reads it, under
either package's names: ``jnp`` or ``torch`` start as ``"torch"``;
``auto``, ``pallas`` or no variable as ``"auto"``; anything else raises.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch

from .utils import trace

_VALID = ("auto", "torch")
_ENV_NAMES = {"auto": "auto", "pallas": "auto", "torch": "torch", "jnp": "torch"}


def _backend_from_env() -> str:
    name = os.environ.get("VACV_BACKEND", "auto")
    if name not in _ENV_NAMES:
        raise ValueError(f"VACV_BACKEND must be one of {tuple(_ENV_NAMES)}, got {name!r}")
    return _ENV_NAMES[name]


_BACKEND = _backend_from_env()
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


# --- route observability --------------------------------------------
# Counters of the routes served: which route actually served each call.
# A CUDA wrapper records its name once per call that launched its kernels
# (one count, however many kernels the call launches; ``native.calls``
# counts the calls into the kernel library), and nowhere else; a
# plain-PyTorch route records its own name, so tests and chip_smoke.py can
# assert which one ran.  They live in the port's tracer
# (``utils/trace.py``) beside its other counters.
record_kernel = trace.count
kernel_count = trace.counter
reset_kernel_counts = trace.reset_counts
