"""imencode — host-side image compression.

The counterpart of ``vacv_tpu/ops/imencode.py``.  The reference wraps
``cv::imencode`` only (``src/cv/imencode.cpp:11-16``); like the
reference, this is *not* a device op: an image on the card is copied to
the host first, then encoded there.  cv2 is preferred (byte-compatible
with the reference's behaviour); PIL is the fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.image import Image, as_image
from ..core.types import Layout
from .layout import change_layout


def imencode(src, ext: str = ".jpg", params=None) -> bytes:
    """Encode an image to ``ext`` format, returning the byte buffer.

    Parity: ``va_cv::imencode`` (cv.h:239).  ``src`` may be HWC or CHW;
    u8 expected (f32 is truncated to u8 like the reference's Tensor
    round-trip would).
    """
    if isinstance(src, np.ndarray):  # already on the host: no trip to the card
        src = Image(torch.from_numpy(np.ascontiguousarray(src)), Layout.HWC)
    img = change_layout(as_image(src), Layout.HWC)
    data = img.data.detach().cpu()  # a CUDA image comes to the host first
    arr = (data.float() if data.is_floating_point() else data).numpy()
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if not ext.startswith("."):
        ext = "." + ext
    try:
        import cv2

        ok, buf = cv2.imencode(ext, arr, params or [])
        if not ok:
            raise RuntimeError(f"imencode failed for {ext}")
        return bytes(buf.tobytes())
    except ImportError:
        import io
        import warnings

        from PIL import Image as PILImage

        fmts = {".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG", ".bmp": "BMP",
                ".webp": "WEBP"}
        fmt = fmts.get(ext.lower())
        if fmt is None:
            raise ValueError(
                f"imencode: unsupported format {ext!r} without cv2 "
                f"(PIL fallback supports {sorted(fmts)})"
            )
        if params:
            warnings.warn(
                "imencode: encode params are cv2-specific and ignored by "
                "the PIL fallback", stacklevel=2,
            )
        rgb = arr[..., ::-1] if arr.ndim == 3 and arr.shape[2] == 3 else arr
        bio = io.BytesIO()
        PILImage.fromarray(rgb).save(bio, format=fmt)
        return bio.getvalue()
