"""cvt_color — NV12/NV21 YUV → BGR/RGB(A) (vacv op #1).

The counterpart of the NV family of ``vacv_tpu/ops/cvt_color.py``.  A
camera frame arrives as one stacked (h·3/2, w) u8 buffer: the Y plane
above ⌈h/2⌉ rows of interleaved chroma pairs (NV21: V, U; NV12: U, V),
one pair for each 2×2 block of Y pixels.  The Q7 integer math is
``nv_to_bgr_naive``'s (``cvt_color.cpp:76-94``):

    ra = (179 (V-128)) >> 7
    ga = (44 (U-128) + 91 (V-128)) >> 7
    ba = (227 (U-128)) >> 7
    B = clamp(Y + ba), G = clamp(Y - ga), R = clamp(Y + ra)

with arithmetic shifts (floor division by 128) on signed int32.  The
reference's NEON path reads NV12 with NV21's chroma order; that quirk is
fixed here on purpose, as in the JAX package (ARCHITECTURE.md).

``nv_to_bgr_planes`` is the dispatcher: under the ``auto`` backend it
goes through the yuv2bgr wrapper (``ops/cuda/yuv2bgr.py``: the CUDA
kernel on a CUDA tensor, ``nv_to_bgr_planes_torch`` on a CPU tensor);
under ``torch`` it runs ``nv_to_bgr_planes_torch`` directly.  Only the
NV codes are ported; the other codes raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from .. import config
from ..core.image import Image, as_image
from ..core.types import ColorCode, Layout

# NV codes → (is_nv12, to_rgb, alpha)
_NV_CODES = {
    ColorCode.COLOR_YUV2RGB_NV12: (True, True, False),
    ColorCode.COLOR_YUV2BGR_NV12: (True, False, False),
    ColorCode.COLOR_YUV2RGB_NV21: (False, True, False),
    ColorCode.COLOR_YUV2BGR_NV21: (False, False, False),
    ColorCode.COLOR_YUV2RGBA_NV12: (True, True, True),
    ColorCode.COLOR_YUV2BGRA_NV12: (True, False, True),
    ColorCode.COLOR_YUV2RGBA_NV21: (False, True, True),
    ColorCode.COLOR_YUV2BGRA_NV21: (False, False, True),
}


def nv_code(code) -> tuple[bool, bool, bool]:
    """(is_nv12, to_rgb, alpha) of an NV code; NotImplementedError for
    any other code."""
    try:
        return _NV_CODES[ColorCode(code)]
    except (KeyError, ValueError):
        raise NotImplementedError(
            f"cvt_color code {code!r} is not ported yet: only the eight "
            "NV12/NV21 codes are; YV12, GRAY and the shuffle and colour-space "
            "codes are ROADMAP.md queue 1 #12"
        ) from None


def check_nv_planes(y_plane: torch.Tensor, vu_plane: torch.Tensor) -> None:
    """Raise ValueError unless Y is (h, w) u8 and VU is (≥⌈h/2⌉, w) u8
    with w even."""
    if y_plane.dtype != torch.uint8 or vu_plane.dtype != torch.uint8:
        raise ValueError("NV planes must be uint8")
    if y_plane.ndim != 2 or vu_plane.ndim != 2:
        raise ValueError("NV planes must be 2-D: Y (h, w) and VU (ceil(h/2), w)")
    h, w = y_plane.shape
    if w % 2:
        raise ValueError("NV buffers need an even width (interleaved VU pairs)")
    if vu_plane.shape[1] != w:
        raise ValueError(f"VU width {vu_plane.shape[1]} != Y width {w}")
    if vu_plane.shape[0] < (h + 1) // 2:
        # The JAX kernel zero-pads a short VU plane; its jnp route cannot
        # take one at all.  Here it is an error on every route.
        raise ValueError(f"VU plane has {vu_plane.shape[0]} rows, needs {(h + 1) // 2}")


def yuv_to_bgr_q7(y: torch.Tensor, first: torch.Tensor, second: torch.Tensor,
                  is_nv12: bool):
    """Q7 decode of int32 Y values and their chroma pair bytes (the pair's
    first and second byte, already spread to Y's shape).  Returns (b, g,
    r) int32 in [0, 255]."""
    u, v = (first, second) if is_nv12 else (second, first)
    u, v = u - 128, v - 128
    # ``>>`` on int32 tensors is an arithmetic shift: negatives floor.
    ra = (179 * v) >> 7
    ga = (44 * u + 91 * v) >> 7
    ba = (227 * u) >> 7
    return (torch.clamp(y + ba, 0, 255), torch.clamp(y - ga, 0, 255),
            torch.clamp(y + ra, 0, 255))


def nv_to_bgr_planes_torch(y_plane, vu_plane, *, is_nv12: bool):
    """Plain PyTorch NV → (b, g, r) u8 planes of Y's shape.

    ``y_plane``: (h, w) u8; ``vu_plane``: (⌈h/2⌉, w) u8 interleaved
    chroma pairs.  Y row r reads chroma row r // 2, so an odd h pairs its
    last row with the last chroma row.  Runs on any device."""
    check_nv_planes(y_plane, vu_plane)
    h = y_plane.shape[0]
    vu = vu_plane[: (h + 1) // 2].to(torch.int32)

    def spread(s):  # (⌈h/2⌉, w/2) -> (h, w): the 2×2 chroma upsample
        return s.repeat_interleave(2, dim=0)[:h].repeat_interleave(2, dim=1)

    b, g, r = yuv_to_bgr_q7(y_plane.to(torch.int32), spread(vu[:, 0::2]),
                            spread(vu[:, 1::2]), is_nv12)
    return b.to(torch.uint8), g.to(torch.uint8), r.to(torch.uint8)


def nv_to_bgr_planes(y_plane, vu_plane, *, is_nv12: bool):
    """(b, g, r) u8 planes from Y (h, w) + interleaved VU (⌈h/2⌉, w):
    the yuv2bgr wrapper under the ``auto`` backend, the plain version
    under ``torch``."""
    if config.use_fused():
        from .cuda.yuv2bgr import nv_to_bgr

        return nv_to_bgr(y_plane, vu_plane, is_nv12=is_nv12)
    return nv_to_bgr_planes_torch(y_plane, vu_plane, is_nv12=is_nv12)


def nv_decode_channels(data: torch.Tensor, code) -> list:
    """Decode an NV stacked buffer into ordered u8 channel planes.

    The shared core of ``cvt_color`` (HWC) and the Preprocessor's chain
    (``models/pipeline._decode_color``, CHW): one place owns the chroma
    order, the channel order (BGR vs RGB) and the alpha plane."""
    is_nv12, to_rgb, alpha = nv_code(code)
    if data.ndim != 2:
        raise ValueError(
            f"NV input must be the (h*3//2, w) stacked buffer, got {tuple(data.shape)}"
        )
    # rows = h + ⌈h/2⌉, so h = rows * 2 // 3 for even and odd h alike.
    full_h = data.shape[0] * 2 // 3
    b, g, r = nv_to_bgr_planes(data[:full_h], data[full_h:], is_nv12=is_nv12)
    chans = [r, g, b] if to_rgb else [b, g, r]
    if alpha:
        chans.append(torch.full_like(b, 255))
    return chans


def cvt_color(src, code) -> Image:
    """Colour conversion (parity: ``va_cv::cvt_color``, cv.h:95), NV
    codes only.

    ``src`` is the stacked NV buffer, an ``Image``, tensor or array of
    shape (h·3/2, w) u8.  Returns an HWC u8 ``Image`` of height
    ``rows * 2 // 3`` (parity: ``dst.create`` at cvt_color.cpp:151-156),
    on the device the buffer lies on."""
    img = as_image(src)
    chans = nv_decode_channels(img.data, code)
    return Image(torch.stack(chans, dim=-1), Layout.HWC)
