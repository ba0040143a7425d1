"""Fused pipelines — resize→normalize and warp_affine→normalize.

The counterpart of ``vacv_tpu/ops/fused.py``.  The reference has these
only as OpenCV call chains (``resize_normalize.cpp:15-107``,
``warp_affine_normalize.cpp:13-189``).  Semantics follow those chains:
the geometric op on the input type (u8 stays u8 through the resize or
warp, as cv::resize does), then f32, then mean/stddev (from the result
when not given), then ``(x−μ)/(σ+1e-6)``.

``resize_normalize`` on a u8 HWC 3-channel bilinear input runs as one
call of the fused preprocess kernel's wrapper (``ops/cuda/preprocess.py``)
and transposes back to HWC; other inputs take the chain.  The warp forms
go planar once before the warp, warp through the warp kernel's wrapper,
and normalize through the ``normalize`` dispatcher (a CHW f32 image with
self statistics goes to the standalone normalize kernel).

``warp_affine_normalize_batch`` is the matrix form over a table of faces:
every face of a batch of frames, each with its own matrix, warped and
normalized with static statistics in one call of the alignment kernel's
wrapper (``ops/cuda/align.py``), the bits of the per-face chain.
"""
from __future__ import annotations

import torch

from .. import config
from ..core.image import Image, as_image, as_tensor
from ..core.types import BorderMode, InterMode, Layout, VScalar, VSize
from .dtype import change_dtype
from .normalize import normalize, normalize_torch
from .resize import resize
from .warp_affine import warp_affine, warp_affine_rot


def resize_normalize(
    src,
    dsize: VSize | tuple | None,
    fx: float = 0.0,
    fy: float = 0.0,
    interpolation: InterMode | int = InterMode.INTER_LINEAR,
    mean=None,
    stddev=None,
) -> Image:
    """Parity: ``va_cv::resize_normalize`` (cv.h:154-158)."""
    img = as_image(src)
    fused = _resize_normalize_fused(img, dsize, fx, fy, interpolation, mean, stddev)
    if fused is not None:
        return fused
    out = resize(img, dsize, fx, fy, interpolation)
    out = change_dtype(out, torch.float32)
    return normalize_torch(out, mean, stddev)


def _resize_normalize_fused(img, dsize, fx, fy, interpolation, mean, stddev):
    """The fused-kernel route for resize_normalize, or None."""
    from .cuda.preprocess import preprocess_fused_batch

    data = img.data
    if (
        not config.use_fused()
        or img.layout != Layout.HWC
        or data.ndim != 3
        or data.shape[-1] != 3
        or data.dtype != torch.uint8
        or InterMode(interpolation) != InterMode.INTER_LINEAR
    ):
        return None
    h, w, _ = data.shape
    if isinstance(dsize, VSize):
        dsize = (dsize.w, dsize.h)
    ow, oh = (0, 0) if dsize is None or not tuple(dsize) else (int(dsize[0]), int(dsize[1]))
    if ow == 0 or oh == 0:
        ow, oh = int(round(w * fx)), int(round(h * fy))
    if ow <= 0 or oh <= 0:
        return None  # resize() raises its documented ValueError
    chw = preprocess_fused_batch(data[None].contiguous(), None, (ow, oh), mean=mean,
                                 stddev=stddev)[0]
    return Image(chw.permute(1, 2, 0).contiguous(), Layout.HWC)


def _warp_normalize_tail(img: Image, warp_fn, mean, stddev) -> Image:
    """Shared body of the two warp_affine_normalize forms: an HWC input
    goes planar once before the warp (the warp kernel and the normalize
    kernel are plane-native), then warp, f32 and the ``normalize``
    dispatcher; the result keeps the caller's layout."""
    hwc = img.data.ndim == 3 and img.layout == Layout.HWC
    if hwc:
        img = img.change_layout(Layout.CHW)
    out = change_dtype(warp_fn(img), torch.float32)
    out = normalize(out, mean, stddev)
    if hwc:
        out = out.change_layout(Layout.HWC)
    return out


def warp_affine_normalize(
    src,
    M,
    dsize: VSize | tuple,
    flags: InterMode | int = InterMode.INTER_LINEAR,
    border_mode: BorderMode | int = BorderMode.BORDER_CONSTANT,
    border_value: VScalar | float = 0.0,
    mean=None,
    stddev=None,
) -> Image:
    """Parity: ``va_cv::warp_affine_normalize`` matrix form (cv.h:172-178)."""
    return _warp_normalize_tail(
        as_image(src),
        lambda im: warp_affine(im, M, dsize, flags, border_mode, border_value),
        mean, stddev,
    )


def warp_affine_normalize_rot(
    src,
    scale: float,
    rot: float,
    dsize: VSize | tuple,
    aux_param: VScalar = VScalar(),
    flags: InterMode | int = InterMode.INTER_LINEAR,
    border_mode: BorderMode | int = BorderMode.BORDER_CONSTANT,
    border_value: VScalar | float = 0.0,
    mean=None,
    stddev=None,
) -> Image:
    """Parity: ``va_cv::warp_affine_normalize`` scale/rot form
    (cv.h:194-201)."""
    return _warp_normalize_tail(
        as_image(src),
        lambda im: warp_affine_rot(im, scale, rot, dsize, aux_param, flags, border_mode,
                                   border_value),
        mean, stddev,
    )


def warp_affine_normalize_batch(frames, index, matrices, dsize: VSize | tuple, mean, stddev,
                                to_rgb: bool = False) -> torch.Tensor:
    """The matrix form of ``warp_affine_normalize`` over a table of K faces
    in (N, H, W, 3) u8 HWC frames: face k is frame ``index[k]`` ((K,) int32)
    warped by its forward matrix ``matrices[k]`` ((K, 2, 3) float32) to
    ``dsize`` (w, h), INTER_LINEAR with BORDER_CONSTANT 0, then
    ``(x - mean) / (stddev + 1e-6)``; returns (K, 3, h, w) float32 CHW, the
    planes in RGB order with ``to_rgb``.  ``mean`` and ``stddev`` are static
    (a scalar or three values), in the output planes' order.  Face k is the
    bits of ``warp_affine_normalize(frames[index[k]], matrices[k], dsize,
    mean=m, stddev=s)`` as CHW, with m, s and the planes reversed for
    ``to_rgb``.

    Under the ``auto`` backend it goes through the alignment kernel's
    wrapper (``ops/cuda/align.py``): one launch on CUDA tensors, the plain
    version on CPU tensors; under ``torch`` it runs the plain version on
    any device.  A numpy argument goes to the frames' device (the default
    device for numpy frames)."""
    from .cuda.align import align_faces, align_faces_torch

    frames = as_tensor(frames)
    index = as_tensor(index, frames.device)
    matrices = as_tensor(matrices, frames.device)
    if isinstance(dsize, VSize):
        dsize = (dsize.w, dsize.h)
    run = align_faces if config.use_fused() else align_faces_torch
    return run(frames, index, matrices, dsize, mean, stddev, to_rgb)
