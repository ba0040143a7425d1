"""cvt_color — colour conversion (vacv op #1).

The counterpart of ``vacv_tpu/ops/cvt_color.py``, every code it takes:
the NV12/NV21 family, YV12, the channel shuffles and gray (OpenCV codes
0-11), and BGR/RGB ↔ YCrCb, YUV and HSV.  All are elementwise PyTorch
ops on the device the input lies on; only the NV decode has a kernel.

NV: a camera frame arrives as one stacked (h·3/2, w) u8 buffer: the Y
plane above ⌈h/2⌉ rows of interleaved chroma pairs (NV21: V, U; NV12: U,
V), one pair for each 2×2 block of Y pixels.  The Q7 integer math is
``nv_to_bgr_naive``'s (``cvt_color.cpp:76-94``):

    ra = (179 (V-128)) >> 7
    ga = (44 (U-128) + 91 (V-128)) >> 7
    ba = (227 (U-128)) >> 7
    B = clamp(Y + ba), G = clamp(Y - ga), R = clamp(Y + ra)

with arithmetic shifts (floor division by 128) on signed int32.  The
reference's NEON path reads NV12 with NV21's chroma order; that quirk is
fixed here on purpose, as in the JAX package (ARCHITECTURE.md).

``nv_to_bgr_planes`` is the NV dispatcher: under the ``auto`` backend it
goes through the yuv2bgr wrapper (``ops/cuda/yuv2bgr.py``: the CUDA
kernel on a CUDA tensor, ``nv_to_bgr_planes_torch`` on a CPU tensor);
under ``torch`` it runs ``nv_to_bgr_planes_torch`` directly.  Gray uses
OpenCV's Q15 coefficients and YCrCb/YUV OpenCV's Q14 constants, bit for
bit the JAX package's integer math; HSV is float math within 1 LSB of it.
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


def nv_code(code) -> tuple[bool, bool, bool] | None:
    """(is_nv12, to_rgb, alpha) of an NV code, None for another code;
    ValueError for an integer that is no ``ColorCode``."""
    return _NV_CODES.get(ColorCode(code))


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
    flags = nv_code(code)
    if flags is None:
        raise ValueError(f"{ColorCode(code)!r} is not an NV code")
    is_nv12, to_rgb, alpha = flags
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


# OpenCV 5's fixed-point gray coefficients (shift 15): gray = (R 9798 +
# G 19235 + B 3735 + 2^14) >> 15 for u8; float inputs use 0.299 / 0.587 /
# 0.114 (vacv_tpu/ops/cvt_color.py:110-135).
_GRAY_R, _GRAY_G, _GRAY_B = 9798, 19235, 3735


def _to_gray(data: torch.Tensor, *, r_idx: int) -> torch.Tensor:
    """BGR(A)/RGB(A) HWC → (h, w) gray with cv2 BGR2GRAY numerics."""
    r, g, b = data[..., r_idx], data[..., 1], data[..., 2 - r_idx]
    if data.dtype == torch.uint8:
        i32 = torch.int32
        acc = (r.to(i32) * _GRAY_R + g.to(i32) * _GRAY_G + b.to(i32) * _GRAY_B
               + (1 << 14)) >> 15
        return acc.to(torch.uint8)
    f32 = torch.float32
    return (r.to(f32) * 0.299 + g.to(f32) * 0.587 + b.to(f32) * 0.114).to(data.dtype)


def _full_alpha(plane: torch.Tensor) -> torch.Tensor:
    return torch.full_like(plane, 255) if plane.dtype == torch.uint8 else torch.ones_like(plane)


def _shuffle_code(img: Image, code: ColorCode) -> Image | None:
    """Channel shuffles and gray (OpenCV codes 0-11) on HWC data; None for
    a code outside this family."""
    C = ColorCode
    data = img.data
    if code in (C.COLOR_GRAY2BGR, C.COLOR_GRAY2BGRA):
        g = data if data.ndim == 2 else data[..., 0]
        chans = [g, g, g]
        if code == C.COLOR_GRAY2BGRA:
            chans.append(_full_alpha(g))
        return Image(torch.stack(chans, dim=-1), Layout.HWC)
    if data.ndim != 3:
        raise ValueError(f"cvt_color code {code!r} needs an HWC image")
    rev = data[..., :3].flip(-1)  # BGR ↔ RGB
    alpha = _full_alpha(data[..., :1])
    if code == C.COLOR_BGR2BGRA:        # also RGB2RGBA
        return Image(torch.cat([data[..., :3], alpha], dim=-1), Layout.HWC)
    if code == C.COLOR_BGRA2BGR:        # also RGBA2RGB
        return Image(data[..., :3], Layout.HWC)
    if code == C.COLOR_BGR2RGBA:        # also RGB2BGRA
        return Image(torch.cat([rev, alpha], dim=-1), Layout.HWC)
    if code == C.COLOR_RGBA2BGR:        # also BGRA2RGB
        return Image(rev, Layout.HWC)
    if code == C.COLOR_BGR2RGB:         # also RGB2BGR
        return Image(data.flip(-1), Layout.HWC)
    if code == C.COLOR_BGRA2RGBA:       # also RGBA2BGRA
        return Image(torch.cat([rev, data[..., 3:4]], dim=-1), Layout.HWC)
    if code in (C.COLOR_BGR2GRAY, C.COLOR_BGRA2GRAY):
        return Image(_to_gray(data, r_idx=2), Layout.HWC)
    if code in (C.COLOR_RGB2GRAY, C.COLOR_RGBA2GRAY):
        return Image(_to_gray(data, r_idx=0), Layout.HWC)
    return None


# ---- YCrCb / YUV / HSV (u8), OpenCV's Q14 constants -------------------
# vacv_tpu/ops/cvt_color.py:191-310: the integer directions are bit for
# bit the JAX package's; HSV is float math within 1 LSB of it.

def _q14(v: torch.Tensor) -> torch.Tensor:
    return (v + (1 << 13)) >> 14


def _rgb_split(data: torch.Tensor, r_idx: int):
    return (data[..., r_idx].to(torch.int32), data[..., 1].to(torch.int32),
            data[..., 2 - r_idx].to(torch.int32))


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 255).to(torch.uint8)


def _to_ycrcb(data, *, r_idx: int):
    r, g, b = _rgb_split(data, r_idx)
    y = _q14(r * 4899 + g * 9617 + b * 1868)
    cr = _u8(_q14((r - y) * 11682) + 128)
    cb = _u8(_q14((b - y) * 9241) + 128)
    return torch.stack([_u8(y), cr, cb], dim=-1)


def _from_ycrcb(data, *, r_idx: int):
    y = data[..., 0].to(torch.int32)
    cr = data[..., 1].to(torch.int32) - 128
    cb = data[..., 2].to(torch.int32) - 128
    r = _u8(y + _q14(cr * 22987))
    g = _u8(y + _q14(cr * -11698 + cb * -5662))
    b = _u8(y + _q14(cb * 29049))
    return torch.stack([r, g, b] if r_idx == 0 else [b, g, r], dim=-1)


def _to_yuv(data, *, r_idx: int):
    r, g, b = _rgb_split(data, r_idx)
    y = _q14(r * 4899 + g * 9617 + b * 1868)
    u = _u8(_q14((b - y) * 8061) + 128)    # 0.492 * 2^14
    v = _u8(_q14((r - y) * 14369) + 128)   # 0.877 * 2^14
    return torch.stack([_u8(y), u, v], dim=-1)


def _from_yuv(data, *, r_idx: int):
    y = data[..., 0].to(torch.int32)
    u = data[..., 1].to(torch.int32) - 128
    v = data[..., 2].to(torch.int32) - 128
    r = _u8(y + _q14(v * 18678))                   # 1.140
    g = _u8(y + _q14(u * -6456 + v * -9519))       # -0.394, -0.581
    b = _u8(y + _q14(u * 33292))                   # 2.032
    return torch.stack([r, g, b] if r_idx == 0 else [b, g, r], dim=-1)


def _to_hsv(data, *, r_idx: int):
    r, g, b = (x.to(torch.float32) for x in _rgb_split(data, r_idx))
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    zero = torch.zeros_like(mx)
    s = torch.where(mx == 0, zero, torch.round(255.0 * diff / torch.clamp(mx, min=1)))
    dd = torch.clamp(diff, min=1e-6)
    h = torch.where(
        diff == 0, zero,
        torch.where(mx == r, 30.0 * (g - b) / dd,
                    torch.where(mx == g, 60.0 + 30.0 * (b - r) / dd,
                                120.0 + 30.0 * (r - g) / dd)),
    )
    h = torch.round(torch.where(h < 0, h + 180.0, h)).to(torch.int32) % 180
    return torch.stack([h.to(torch.uint8), _u8(s.to(torch.int32)), _u8(mx.to(torch.int32))],
                       dim=-1)


def _from_hsv(data, *, r_idx: int):
    """HSV (cv2's u8 convention, H in 0..180) → BGR/RGB by the closed-form
    sector evaluation ``f(n) = v − v·s·clamp(min(k, 4−k), 0, 1)`` with
    ``k = (n + h/30) mod 6`` (n = 5, 3, 1 for R, G, B)."""
    p = data.movedim(-1, 0).to(torch.float32)
    h, s, v = p[0], p[1] / 255.0, p[2]
    h6 = h / 30.0

    def chan(n):
        k = torch.remainder(n + h6, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    chans = [_u8(torch.round(chan(n)).to(torch.int32)) for n in (5.0, 3.0, 1.0)]  # R, G, B
    return torch.stack(chans[::-1] if r_idx == 2 else chans, dim=-1)


_COLORSPACE_CODES = {
    ColorCode.COLOR_BGR2YCrCb: (_to_ycrcb, 2),
    ColorCode.COLOR_RGB2YCrCb: (_to_ycrcb, 0),
    ColorCode.COLOR_YCrCb2BGR: (_from_ycrcb, 2),
    ColorCode.COLOR_YCrCb2RGB: (_from_ycrcb, 0),
    ColorCode.COLOR_BGR2HSV: (_to_hsv, 2),
    ColorCode.COLOR_RGB2HSV: (_to_hsv, 0),
    ColorCode.COLOR_HSV2BGR: (_from_hsv, 2),
    ColorCode.COLOR_HSV2RGB: (_from_hsv, 0),
    ColorCode.COLOR_BGR2YUV: (_to_yuv, 2),
    ColorCode.COLOR_RGB2YUV: (_to_yuv, 0),
    ColorCode.COLOR_YUV2BGR: (_from_yuv, 2),
    ColorCode.COLOR_YUV2RGB: (_from_yuv, 0),
}


def _yv12_to_bgr(data: torch.Tensor) -> torch.Tensor:
    """YV12: planar Y (h, w), then V (h/2, w/2), then U (h/2, w/2), packed
    into one (h·3/2, w) buffer; the Q7 decode of the NV codes."""
    full_h, w = data.shape[0] * 2 // 3, data.shape[1]
    chroma = data[full_h:].reshape(-1)
    half = (full_h // 2) * (w // 2)
    v_s = chroma[:half].reshape(full_h // 2, w // 2).to(torch.int32)
    u_s = chroma[half:].reshape(full_h // 2, w // 2).to(torch.int32)

    def up(x):  # the 2×2 chroma upsample
        return x.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)

    b, g, r = yuv_to_bgr_q7(data[:full_h].to(torch.int32), up(u_s), up(v_s), is_nv12=True)
    return torch.stack([b, g, r], dim=-1).to(torch.uint8)


def cvt_color(src, code) -> Image:
    """Colour conversion (parity: ``va_cv::cvt_color``, cv.h:95), every
    code of ``vacv_tpu.cvt_color``, in its order.

    For NV and YV12 codes ``src`` is the stacked buffer, an ``Image``,
    tensor or array of shape (h·3/2, w) u8, and the result is HWC u8 of
    height ``rows * 2 // 3`` (parity: ``dst.create`` at
    cvt_color.cpp:151-156); the shuffles, gray and the colour spaces take
    an HWC image.  The result lies on the device the input lies on."""
    img = as_image(src)
    code = ColorCode(code)
    if int(code) < 12:  # channel-shuffle / gray family
        out = _shuffle_code(img, code)
        if out is not None:
            return out
    if code in _COLORSPACE_CODES:
        fn, r_idx = _COLORSPACE_CODES[code]
        if img.data.ndim != 3 or img.data.dtype != torch.uint8:
            raise ValueError(f"{code!r} needs an HWC uint8 image")
        return Image(fn(img.data, r_idx=r_idx), Layout.HWC)
    if code == ColorCode.COLOR_YUV2BGR_YV12:
        return Image(_yv12_to_bgr(img.data), Layout.HWC)
    if code not in _NV_CODES:
        raise NotImplementedError(
            f"cvt_color code {code!r} not supported; supported codes are "
            "the NV12/NV21 YUV->BGR/RGB(A) family, YV12/I420, "
            "GRAY<->BGR(A), BGR<->RGB(A) shuffles, and BGR<->YCrCb/YUV/"
            "HSV (see ColorCode).  For other conversions, decode to BGR "
            "with cv2/PIL on the host first."
        )
    chans = nv_decode_channels(img.data, code)
    return Image(torch.stack(chans, dim=-1), Layout.HWC)
