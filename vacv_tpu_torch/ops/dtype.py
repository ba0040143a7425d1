"""dtype_change — u8↔float (vacv op #4).

The counterpart of ``vacv_tpu/ops/dtype.py``, with the reference's
semantics (``tensor.cpp:297-502``):

* u8 → float: plain widening, exact.
* float → u8: **truncation toward zero**, then saturation to [0, 255]
  (the NEON ``vcvtq_u32_f32`` + saturating narrows, ``tensor.cpp:349-390``),
  not round-half-to-even.

Admitted float types are float32, float16, bfloat16 and float64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.image import Image, as_image

_FLOATS = (torch.float32, torch.float16, torch.bfloat16, torch.float64)


def as_torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a name ("float32") or a
    numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


def _to_u8(data):
    # Truncate toward zero, then saturate to [0, 255] — the reference
    # NEON path.  trunc before clamp keeps out-of-range values defined.
    return torch.clamp(torch.trunc(data), 0, 255).to(torch.uint8)


def change_dtype(src, dtype) -> Image:
    """Convert ``src`` to ``dtype``.

    Supported: uint8 ↔ {float32, float16, bfloat16, float64} and
    conversions among the float types.  float→u8 always truncates
    toward zero and saturates.

    Accepts an ``Image`` or raw tensor / array (assumed HWC).
    """
    img = as_image(src)
    dtype = as_torch_dtype(dtype)
    if img.data.dtype == dtype:
        return img
    if dtype in _FLOATS:
        out = img.data.to(dtype)
    elif dtype == torch.uint8:
        out = _to_u8(img.data.to(torch.float32))
    else:
        raise NotImplementedError(
            "change_dtype supports uint8 <-> {float32,float16,bfloat16,"
            "float64} and float-to-float conversions; got "
            f"{dtype}.  For integer targets other than uint8, convert "
            "to float32 first and cast with Tensor.to."
        )
    return img.with_data(out)
