"""match_template + minMaxIdx — all six TM_* modes.

The counterpart of ``vacv_tpu/ops/match_template.py``, with OpenCV's
documented mode formulas (the reference wraps ``cv::matchTemplate`` /
``cv::minMaxIdx``, ``match_template.cpp:13-61``); multi-channel images sum
the numerator and the denominator over channels.

The correlation core ``corr`` goes through the correlation kernel's
wrapper (``ops/cuda/match_template.py``: the CUDA kernel on a CUDA tensor,
its plain version ``conv2d`` in f32 on a CPU tensor) under the ``auto``
backend, and runs the plain version under ``torch``.  The windowed sums
the SQDIFF / NORMED / CCOEFF families need (the window sums of Σ_c x² and,
for TM_CCOEFF_NORMED, of each channel) go the same way through the
window-sum kernel's wrapper (``ops/cuda/window_sum.py``: one launch a
call on the card, both sums at once; its plain version is the reference's
two f32 ones-band matrix products).  Results stay on the device: nothing
here reads a value back.
"""
from __future__ import annotations

import torch

from .. import config
from ..core.image import Image, as_image
from ..core.types import Layout, MatchMode


def _nchw(img: Image) -> torch.Tensor:
    """(1, C, H, W) f32 view of an image (HWC, CHW or 2-D)."""
    d = img.data.to(torch.float32)
    if d.ndim == 2:
        return d[None, None]
    if img.layout == Layout.HWC:
        d = d.permute(2, 0, 1)
    return d[None]


def corr(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation of x (1, C, H, W) f32 with k (1, C, th, tw)
    f32 → (H-th+1, W-tw+1), summed over channels."""
    from .cuda.match_template import corr_planes, corr_planes_torch

    if config.use_fused():
        return corr_planes(x[0], k[0])
    return corr_planes_torch(x[0], k[0])


def window_sums(x: torch.Tensor, th: int, tw: int, *, sums: bool = False):
    """(sq, sums) of x (1, C, H, W) f32 over th × tw windows: the window
    sums of Σ_c x² (H-th+1, W-tw+1) and, with ``sums``, the per-channel
    window sums (C, H-th+1, W-tw+1), else None."""
    from .cuda.window_sum import window_sums as kernel
    from .cuda.window_sum import window_sums_torch

    fn = kernel if config.use_fused() else window_sums_torch
    return fn(x[0], th, tw, sq=True, sums=sums)


def match_template(src, target, method: MatchMode | int) -> Image:
    """Parity: ``va_cv::match_template`` (cv.h:218-219).  Returns the
    (H-th+1, W-tw+1) float32 response map as an ``Image``."""
    method = MatchMode(method)
    x = _nchw(as_image(src))
    k = _nchw(as_image(target))  # (1, C, th, tw), the correlation kernel
    th, tw = k.shape[2], k.shape[3]
    n = th * tw

    if method in (MatchMode.TM_CCORR, MatchMode.TM_CCORR_NORMED):
        num = corr(x, k)
        if method == MatchMode.TM_CCORR:
            return Image(num, Layout.HWC)
        wnd2, _ = window_sums(x, th, tw)
        denom = torch.sqrt(wnd2 * torch.sum(k * k))
        return Image(_normed_div(num, denom, sqdiff=False), Layout.HWC)

    if method in (MatchMode.TM_SQDIFF, MatchMode.TM_SQDIFF_NORMED):
        cc = corr(x, k)
        wnd2, _ = window_sums(x, th, tw)
        t2 = torch.sum(k * k)
        num = wnd2 - 2.0 * cc + t2
        if method == MatchMode.TM_SQDIFF:
            return Image(num, Layout.HWC)
        denom = torch.sqrt(wnd2 * t2)
        return Image(_normed_div(num, denom, sqdiff=True), Layout.HWC)

    # CCOEFF family: mean-centred template per channel.
    kc = k - torch.mean(k, dim=(2, 3), keepdim=True)
    num = corr(x, kc)
    if method == MatchMode.TM_CCOEFF:
        return Image(num, Layout.HWC)
    # Window variance summed over channels: Σ_c [Σw x² − (Σw x)²/n].
    wnd2, wnd1 = window_sums(x, th, tw, sums=True)  # (H', W'), (C, H', W')
    wnd_var = wnd2 - torch.sum(wnd1 * wnd1, dim=0) / n
    denom = torch.sqrt(torch.clamp(wnd_var, min=0.0) * torch.sum(kc * kc))
    return Image(_normed_div(num, denom, sqdiff=False), Layout.HWC)


def _normed_div(num, denom, *, sqdiff: bool):
    """OpenCV's NORMED post-processing: |num| < den → num/den;
    |num| < 1.125·den → ±1; else 1 for SQDIFF_NORMED, 0 otherwise (guards
    out-of-range responses and ill-conditioned flat windows, as
    cv::matchTemplate does)."""
    a = torch.abs(num)
    ratio = num / torch.where(denom > 0, denom, torch.ones_like(denom))
    near = torch.where(num > 0, 1.0, -1.0)
    far = torch.full_like(num, 1.0 if sqdiff else 0.0)
    return torch.where(a < denom, ratio, torch.where(a < 1.125 * denom, near, far))


def min_max_idx(src, mask=None):
    """Parity: ``va_cv::minMaxIdx`` (cv.h:230-231).

    Returns ``(min_val, max_val, min_idx, max_idx)`` as 0-d tensors on the
    input's device; the indices are flat (row-major) positions, the first
    one on ties.  With a ``mask`` only its nonzero positions count; when
    it masks everything the values are NaN.

    Nothing is read back, so a CUDA graph can capture the call: the values
    come from the reductions themselves or from ``take``, never from
    indexing by a 0-d tensor, which reads the index back to the host.
    """
    flat = as_image(src).data.to(torch.float32).reshape(-1)
    if mask is None:
        min_val, min_idx = torch.min(flat, 0)
        max_val, max_idx = torch.max(flat, 0)
        return min_val, max_val, min_idx, max_idx
    m = as_image(mask).data.reshape(-1).to(flat.device) != 0
    big = torch.finfo(torch.float32).max
    min_idx = torch.argmin(torch.where(m, flat, big))
    max_idx = torch.argmax(torch.where(m, flat, -big))
    none = torch.logical_not(torch.any(m))
    nan = torch.full((), float("nan"), device=flat.device)
    return (torch.where(none, nan, flat.take(min_idx)), torch.where(none, nan, flat.take(max_idx)),
            min_idx, max_idx)


def min_max_loc(src, mask=None):
    """``cv::minMaxLoc``-style variant: ``(min_val, max_val, (min_x,
    min_y), (max_x, max_y))`` of a 2-D response map, all 0-d tensors on
    its device."""
    img = as_image(src)
    w = img.data.shape[1]
    mn, mx, mi, ma = min_max_idx(img, mask)
    return mn, mx, (mi % w, mi // w), (ma % w, ma // w)
