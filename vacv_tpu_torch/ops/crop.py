"""crop — rectangular ROI extraction (vacv op #2).

The counterpart of ``vacv_tpu/ops/crop.py``.  A crop with a static
rectangle is a slice (a view; no copy).  ``crop_dynamic`` takes a
``left``/``top`` that may be a 0-d tensor, so a moving ROI whose offset
lives on the device never synchronises the host; like
``lax.dynamic_slice`` in the JAX package, each start is clamped so the
window stays inside the image.

Rect semantics match the reference dispatcher: float fields are
truncated to int via ``VRect.int_bounds`` (reference ``crop.cpp:127-131``).
"""
from __future__ import annotations

import torch

from ..core.image import Image, as_image
from ..core.types import Layout, VRect


def crop(src, rect: VRect) -> Image:
    """Crop ``rect`` out of ``src`` (static rectangle).

    Accepts an ``Image`` or raw tensor / array (assumed HWC).
    """
    img = as_image(src)
    left, top, w, h = rect.int_bounds()
    if w <= 0 or h <= 0:
        raise ValueError(f"empty crop rect {rect}")
    if img.data.ndim == 2:
        out = img.data[top : top + h, left : left + w]
    elif img.layout == Layout.HWC:
        out = img.data[top : top + h, left : left + w, :]
    else:
        out = img.data[:, top : top + h, left : left + w]
    return img.with_data(out)


def static_start(start: int, n: int, size: int) -> int:
    """An int start of ``size`` entries in ``n`` under ``lax.dynamic_slice``'s
    rules: a negative start counts from the end once, then it is clamped to
    ``[0, n - size]``."""
    start = start + n if start < 0 else start
    return min(max(start, 0), n - size)


def dynamic_slice(x: torch.Tensor, dim: int, start, size: int) -> torch.Tensor:
    """``size`` entries of ``x`` along ``dim`` from ``start``, with
    ``lax.dynamic_slice``'s index rules: a negative start counts from
    the end once, then the start is clamped to ``[0, x.shape[dim] - size]``.

    ``start`` is an int (a view) or a 0-d integer tensor (a gather on
    the tensor's device, with no host synchronisation)."""
    n = x.shape[dim]
    hi = n - size
    if hi < 0:
        raise ValueError(f"slice of {size} exceeds dim {dim} of {tuple(x.shape)}")
    if not isinstance(start, torch.Tensor):
        return x.narrow(dim, static_start(int(start), n, size), size)
    start = start.to(device=x.device, dtype=torch.int64).reshape(())
    start = torch.clamp(torch.where(start < 0, start + n, start), 0, hi)
    idx = torch.arange(size, device=x.device) + start
    return x.index_select(dim, idx)


def crop_dynamic(src, left, top, w: int, h: int) -> Image:
    """Crop with a runtime ``left``/``top`` (int or 0-d tensor); sizes
    are static."""
    img = as_image(src)
    planar = img.data.ndim == 3 and img.layout == Layout.CHW
    ydim, xdim = (1, 2) if planar else (0, 1)
    out = dynamic_slice(img.data, ydim, top, h)
    out = dynamic_slice(out, xdim, left, w)
    return img.with_data(out)
