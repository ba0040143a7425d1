"""Host-side image IO and YUV input synthesis.

The counterpart of ``vacv_tpu/utils/io.py``.  The reference test harness
reads JPEG assets with ``cv::imread`` and synthesizes NV21 input from BGR
via integer coefficients (``ImageUtil::bgr2nv21``, reference
``src/util/image_util.cpp:3-41``).  This module is the host-side feeder:
decode happens on the CPU, and the pixels then go to the card
(``utils/loader.BatchLoader.to_device``, or any op given a numpy array).

``bgr2nv21`` prefers the native C++ library (``vacv_tpu_torch/native.py``,
counted ``native_bgr2nv21``) for even heights, falling back to
vectorized numpy.
"""
from __future__ import annotations

import numpy as np

# Integer BGR->NV21 coefficients, Q14 fixed point
# (reference image_util.cpp:3-7: R2YI=4899 G2YI=9617 B2YI=1868
#  B2UI=9241 R2VI=11682, shift 14).
_B2Y, _G2Y, _R2Y = 1868, 9617, 4899
_B2U, _R2V = 9241, 11682
_SHIFT = 14
_OFFSET = 128 << _SHIFT


def imread(path: str) -> np.ndarray:
    """Read an image file as HWC BGR uint8 (like cv::imread)."""
    try:
        import cv2

        img = cv2.imread(path, 1)
        if img is None:
            raise FileNotFoundError(path)
        return img
    except ImportError:
        from PIL import Image as PILImage

        rgb = np.asarray(PILImage.open(path).convert("RGB"))
        return rgb[..., ::-1].copy()


def bgr2nv21_numpy(bgr: np.ndarray) -> np.ndarray:
    """Synthesize an NV21 buffer from HWC BGR uint8.

    Bit-exact with the reference's integer path: Y from all pixels via
    Q14 coefficients; V,U subsampled at even rows/cols, computed from
    (B - Y) and (R - Y) with the +128 offset, all right-shifted by 14
    with C unsigned-shift semantics (image_util.cpp:25-38).

    Width must be even (the VU interleave needs byte pairs); odd
    heights produce ``ceil(h/2)`` chroma rows — the last chroma row
    covers a single Y row, mirroring the reference decoder's
    zerobuf/writebuf odd-height handling (cvt_color.cpp:52-66).
    """
    h, w, _ = bgr.shape
    if w % 2:
        raise ValueError("bgr2nv21 requires even width")
    b = bgr[..., 0].astype(np.uint32)
    g = bgr[..., 1].astype(np.uint32)
    r = bgr[..., 2].astype(np.uint32)
    y = (b * _B2Y + g * _G2Y + r * _R2Y) >> _SHIFT

    # Subsample at even rows/cols; (B - Y) can be negative — the
    # reference computes it in unsigned int, relying on mod-2^32
    # wraparound before the unsigned shift.  np.uint32 reproduces that.
    b_s = b[0::2, 0::2]
    r_s = r[0::2, 0::2]
    y_s = y[0::2, 0::2]
    u = ((b_s - y_s) * np.uint32(_B2U) + np.uint32(_OFFSET)) >> _SHIFT
    v = ((r_s - y_s) * np.uint32(_R2V) + np.uint32(_OFFSET)) >> _SHIFT

    ch = (h + 1) // 2  # chroma rows (ceil for odd heights)
    out = np.empty(h * w + ch * w, dtype=np.uint8)
    out[: h * w] = y.astype(np.uint8).ravel()
    vu = np.empty((ch, w), dtype=np.uint8)
    vu[:, 0::2] = v.astype(np.uint8)
    vu[:, 1::2] = u.astype(np.uint8)
    out[h * w :] = vu.ravel()
    return out


def bgr2nv21(bgr: np.ndarray) -> np.ndarray:
    """NV21 synthesis; native C++ fast path when available (even
    heights only — odd heights use the numpy path)."""
    if bgr.shape[0] % 2 == 0:
        from ..native import bgr2nv21 as native_impl

        return native_impl(bgr)
    return bgr2nv21_numpy(bgr)


def nv21_planes(nv21: np.ndarray, w: int, h: int):
    """Split a flat NV21 buffer into (Y:(h,w), VU:(ceil(h/2),w)) views."""
    y = nv21[: h * w].reshape(h, w)
    vu = nv21[h * w :].reshape((h + 1) // 2, w)
    return y, vu
