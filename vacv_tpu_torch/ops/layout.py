"""layout_change — HWC↔CHW (vacv op #3).

The counterpart of ``vacv_tpu/ops/layout.py``.  The reference
hand-vectorizes the 3-channel de/interleave with NEON
(``tensor.cpp:160-295,393-457``); here it is ``permute`` followed by
``contiguous``, so the result owns a dense copy in the new layout.
"""
from __future__ import annotations

from ..core.image import Image, as_image
from ..core.types import Layout


def _change_layout_tensor(data, src_layout: Layout, dst_layout: Layout):
    if src_layout == dst_layout or data.ndim == 2:
        # Parity: same-layout / single-channel input returns as is
        # (reference tensor.cpp:393-401).
        return data
    if src_layout == Layout.HWC:  # HWC -> CHW
        return data.permute(2, 0, 1).contiguous()
    return data.permute(1, 2, 0).contiguous()  # CHW -> HWC


def change_layout(src, dst_layout: Layout) -> Image:
    """Return ``src`` converted to ``dst_layout``.

    Accepts an ``Image`` or a raw tensor / array (assumed HWC).
    """
    img = as_image(src)
    out = _change_layout_tensor(img.data, img.layout, dst_layout)
    return Image(out, dst_layout)
