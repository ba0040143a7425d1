"""Per-plane self-statistics normalize: the normalize kernel's wrapper.

The counterpart of ``vacv_tpu/ops/pallas/normalize.py::
normalize_fused_pallas``.  ``normalize_fused`` takes P contiguous planes
(P, h, w) of u8 or f32 and returns ``(x−μ)/(σ+1e-6)`` as f32, each plane
with its own mean and population stddev.  On a CUDA tensor it launches
the hand-written kernel (``vacv_tpu_torch/csrc/normalize.cu``), counted
as ``"normalize_fused"``, or raises; on a CPU tensor it runs the plain
version ``ops/normalize.py::normalize_torch``, counted as
``"normalize_fused_torch"``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import config
from ...core.image import Image
from ...core.types import Layout
from ..normalize import normalize_torch
from . import build

_MAX_PLANES = 65535  # the kernel's grid y dimension


@functools.lru_cache(maxsize=1)
def _entry_points():
    lib = build.library().lib
    i, p = ctypes.c_int, ctypes.c_void_p
    chunk = lib.vacv_normalize_chunk
    chunk.restype, chunk.argtypes = i, []
    fn = lib.vacv_normalize_planes
    fn.restype = i
    # device, stream, x, is_u8, out, planes, plane, part, stats
    fn.argtypes = [i, p, p, i, p, i, ctypes.c_longlong, p, p]
    return lib, chunk(), fn


def _launch(planes):
    if planes.ndim != 3:
        raise ValueError(f"normalize kernel needs (P, h, w) planes, got {tuple(planes.shape)}")
    if planes.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"normalize kernel takes uint8 or float32, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("normalize kernel needs contiguous planes")
    p, h, w = planes.shape
    if p > _MAX_PLANES:
        raise ValueError(f"normalize kernel takes at most {_MAX_PLANES} planes")
    dev = planes.device
    out = torch.empty((p, h, w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib, chunk, fn = _entry_points()
    chunks = -(-(h * w) // chunk)
    part = torch.empty((p, chunks, 3), dtype=torch.float32, device=dev)
    stats = torch.empty((p, 2), dtype=torch.float32, device=dev)
    rc = fn(dev.index, torch.cuda.current_stream(dev).cuda_stream,
            planes.data_ptr(), int(planes.dtype == torch.uint8), out.data_ptr(),
            p, h * w, part.data_ptr(), stats.data_ptr())
    build.check(lib, rc, "normalize kernel")
    config.record_kernel("normalize_fused")
    return out


def normalize_fused(planes: torch.Tensor) -> torch.Tensor:
    """Self-normalize each of the (P, h, w) planes; f32 out.

    Raises ValueError for planes the kernel does not take (not rank 3,
    not u8 or f32, not contiguous)."""
    if planes.device.type == "cuda":
        return _launch(planes)
    if planes.device.type != "cpu":
        raise ValueError(f"no normalize route for device {planes.device}")
    out = normalize_torch(Image(planes, Layout.CHW)).data
    config.record_kernel("normalize_fused_torch")
    return out
