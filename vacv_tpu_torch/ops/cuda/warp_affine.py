"""Batched affine warp of strided planes: the warp kernel's wrapper.

The counterpart of ``vacv_tpu/ops/pallas/warp_affine.py::
warp_affine_pallas``.  ``warp_planes_batch`` warps (N, C, h, w) planes of
any strides (CHW planes, HWC frames through a permuted view, a crop view
of either) with one inverse matrix into (N, C, h_out, w_out) in the
input's type, for every interpolation (linear, nearest, cubic) and border
(CONSTANT with a border value, REPLICATE, REFLECT, REFLECT_101, WRAP), and
the reference's ``edge_mode="vacv"`` skip-edge mask.

On a CUDA tensor it launches the hand-written kernel
(``vacv_tpu_torch/csrc/warp_affine.cu``), counted as ``"warp_affine"``, or
raises: u8 and f32 directly, other float types through an f32 copy and
narrowed on write-out.  On a CPU tensor it runs the plain version
``warp_planes_batch_torch``, counted as ``"warp_affine_torch"``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import config
from ...core.types import BorderMode, InterMode
from ..warp_affine import INTERPS, warp_epilogue, warp_planes_torch
from . import build

_MAX_GRID_Z = 65535  # frames x channel groups
_BORDERS = (BorderMode.BORDER_CONSTANT, BorderMode.BORDER_REPLICATE, BorderMode.BORDER_REFLECT,
            BorderMode.BORDER_WRAP, BorderMode.BORDER_REFLECT_101)


@functools.lru_cache(maxsize=1)
def _entry_points():
    lib = build.library().lib
    i, p, ll, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    group = lib.vacv_warp_affine_group
    group.restype, group.argtypes = i, []
    fn = lib.vacv_warp_affine
    fn.restype = i
    fn.argtypes = [
        i, p, p, i, i, i, i, i,       # device, stream, src, is_u8, n, c, h, w
        ll, ll, ll, ll,               # source strides n, c, y, x
        p, i, i, ll, ll, ll, ll,      # out, h_out, w_out, output strides n, c, y, x
        f, f, f, f, f, f,             # the inverse matrix
        i, i, f, i,                   # interp, border, border value, vacv
    ]
    return lib, group(), fn


def _check(planes, interp, border):
    if planes.ndim != 4:
        raise ValueError(f"warp needs (N, C, h, w) planes, got {tuple(planes.shape)}")
    if InterMode(interp) not in INTERPS:
        raise ValueError(f"warp interpolation must be one of {[m.name for m in INTERPS]}, "
                         f"got {interp!r}")
    if BorderMode(border) not in _BORDERS:
        raise ValueError(f"warp border must be one of {[b.name for b in _BORDERS]}, got {border!r}")
    if not (planes.dtype == torch.uint8 or planes.dtype.is_floating_point):
        raise ValueError(f"warp takes uint8 or a float type, got {planes.dtype}")


def warp_planes_batch_torch(planes, minv, h_out: int, w_out: int, *,
                            interp=InterMode.INTER_LINEAR,
                            border=BorderMode.BORDER_CONSTANT, border_value=0.0,
                            edge_mode="opencv"):
    """Plain PyTorch version of the kernel: ``warp_planes_torch`` on the
    planes in f32, then the epilogue to the input's type.  Runs on any
    device."""
    _check(planes, interp, border)
    res = warp_planes_torch(planes.to(torch.float32), minv, h_out, w_out,
                            u8=planes.dtype == torch.uint8, border_value=border_value,
                            edge_mode=edge_mode, border=border, interp=interp)
    return warp_epilogue(res, interp, planes.dtype)


def _launch(planes, minv, h_out, w_out, interp, border, bv, vacv, out):
    n, c, h, w = planes.shape
    lib, group, fn = _entry_points()
    if n * -(-c // group) > _MAX_GRID_Z:
        raise ValueError(f"warp kernel takes at most {_MAX_GRID_Z} frame x channel groups")
    if h_out > 65535 * 8:
        raise ValueError("warp kernel output is too tall")
    dev = planes.device
    if out.numel() == 0 or planes.numel() == 0:
        if out.numel():
            raise ValueError("warp of an empty image")
        return out
    m = np.asarray(minv, np.float32).reshape(6)
    rc = fn(dev.index, torch.cuda.current_stream(dev).cuda_stream,
            planes.data_ptr(), int(planes.dtype == torch.uint8), n, c, h, w, *planes.stride(),
            out.data_ptr(), h_out, w_out, *out.stride(),
            *(float(v) for v in m), int(InterMode(interp)), int(BorderMode(border)),
            float(bv), int(vacv))
    build.check(lib, rc, "warp kernel")
    config.record_kernel("warp_affine")
    return out


def warp_planes_batch(planes, minv, h_out: int, w_out: int, *,
                      interp=InterMode.INTER_LINEAR, border=BorderMode.BORDER_CONSTANT,
                      border_value=0.0, edge_mode="opencv", out=None):
    """Warp (N, C, h, w) planes of any strides with the 2×3 inverse matrix
    ``minv`` into (N, C, h_out, w_out) of the planes' type.

    ``out``, if given, is written in place (any strides, e.g. a permuted
    view of an HWC tensor) and returned.  Raises ValueError for inputs the
    kernel does not take (not rank 4, an integer type other than uint8,
    an interpolation other than linear/nearest/cubic, a border other than
    CONSTANT/REPLICATE/REFLECT/WRAP/REFLECT_101)."""
    _check(planes, interp, border)
    shape = planes.shape[:2] + (h_out, w_out)
    if out is None:
        out = torch.empty(shape, dtype=planes.dtype, device=planes.device)
    elif tuple(out.shape) != tuple(shape) or out.dtype != planes.dtype or out.device != planes.device:
        raise ValueError(f"out must be {tuple(shape)} {planes.dtype} on {planes.device}")
    vacv = edge_mode == "vacv"
    if planes.device.type == "cuda":
        if planes.dtype in (torch.uint8, torch.float32):
            return _launch(planes, minv, h_out, w_out, interp, border, border_value, vacv, out)
        # f16 / bf16 / f64: warped in f32 and narrowed on write-out.
        wide = torch.empty(shape, dtype=torch.float32, device=planes.device)
        _launch(planes.to(torch.float32), minv, h_out, w_out, interp, border, border_value,
                vacv, wide)
        return out.copy_(wide)
    if planes.device.type != "cpu":
        raise ValueError(f"no warp route for device {planes.device}")
    out.copy_(warp_planes_batch_torch(planes, minv, h_out, w_out, interp=interp, border=border,
                                      border_value=border_value, edge_mode=edge_mode))
    config.record_kernel("warp_affine_torch")
    return out
