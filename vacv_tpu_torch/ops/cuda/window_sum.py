"""Window sums for template matching: the window-sum kernel's wrapper.

``window_sums`` takes f32 planes x (C, H, W) of any strides (CHW planes, or
an HWC image through a permuted view) and a th × tw window, and returns
``(sq, sums)``: ``sq`` (H', W') the window sums of Σ_c x², ``sums`` (C,
H', W') the per-channel window sums (H' = H − th + 1, W' = W − tw + 1),
each only where the caller asks for it, None otherwise.  ``match_template``
needs ``sq`` for the SQDIFF and CCORR_NORMED modes and both for
TM_CCOEFF_NORMED.

No TPU kernel stands behind it: ``vacv_tpu/ops/match_template.py:37``
(``_box_sum``) takes these sums as two dense ones-band matrix products,
0/1 selection matmuls the TPU needs for want of a fast gather.  The plain
version ``window_sums_torch`` is those products, as the port ran them
before this kernel.

On a CUDA tensor ``window_sums`` launches the hand-written kernel
(``vacv_tpu_torch/csrc/window_sum.cu``) once, whatever it is asked for,
counted as ``"window_sum"``, or raises; on a CPU tensor it runs the plain
version, counted as ``"window_sum_torch"``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import config
from ...core.device_tables import stream_cached, stream_key
from . import build


@stream_cached(maxsize=128)
def _ones_band(n_in: int, taps: int, device: torch.device) -> torch.Tensor:
    """(n_in - taps + 1, n_in) band-of-ones windowed-sum matrix on
    ``device``, made once for each CUDA stream (``core/device_tables.py``)."""
    n_out = n_in - taps + 1
    w = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        w[o, o : o + taps] = 1.0
    return torch.from_numpy(w).to(device)


def _box_sum(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Sliding-window (th, tw) sum over the trailing (H, W) axes of ``x``
    → (..., H-th+1, W-tw+1), as two f32 ones-band products."""
    wv = _ones_band(x.shape[-2], th, x.device)
    wx = _ones_band(x.shape[-1], tw, x.device)
    return torch.matmul(torch.matmul(wv, x), wx.T)


def _check(x, th, tw, sq, sums):
    if x.ndim != 3 or x.dtype != torch.float32:
        raise ValueError(f"window sums need (C, H, W) float32, got {tuple(x.shape)} {x.dtype}")
    if not (1 <= th <= x.shape[1] and 1 <= tw <= x.shape[2]):
        raise ValueError(f"a {th}x{tw} window does not fit image {tuple(x.shape)}")
    if not (sq or sums):
        raise ValueError("ask for sq, sums or both")


def window_sums_torch(x: torch.Tensor, th: int, tw: int, *, sq: bool = True,
                      sums: bool = False):
    """Plain PyTorch version: ``(sq, sums)`` as two f32 ones-band products
    each (``_box_sum``).  Runs on any device; on a card, turn TF32 off
    (``torch.backends.cuda.matmul.allow_tf32``) for f32 results."""
    _check(x, th, tw, sq, sums)
    wnd2 = _box_sum(torch.sum(x * x, dim=0), th, tw) if sq else None
    wnd1 = _box_sum(x, th, tw) if sums else None
    return wnd2, wnd1


@functools.lru_cache(maxsize=1)
def _entry_points():
    lib = build.library().lib
    i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    fn = lib.vacv_window_sum
    fn.restype = i
    # device, stream, x, c, h, w, strides c/y/x, th, tw, sq, sums
    fn.argtypes = [i, p, p, i, i, i, ll, ll, ll, i, i, p, p]
    return lib, fn


def _launch(x, th, tw, sq, sums):
    c, h, w = x.shape
    if min(x.stride()) < 0:
        raise ValueError("window-sum kernel needs non-negative strides")
    if -(-(h - th + 1) // 32) > 65535:
        raise ValueError("window-sum kernel output is too tall")
    dev = x.device
    ho, wo = h - th + 1, w - tw + 1
    wnd2 = torch.empty((ho, wo), dtype=torch.float32, device=dev) if sq else None
    wnd1 = torch.empty((c, ho, wo), dtype=torch.float32, device=dev) if sums else None
    lib, fn = _entry_points()
    rc = fn(dev.index, stream_key(dev), x.data_ptr(), c, h, w, *x.stride(), th, tw,
            None if wnd2 is None else wnd2.data_ptr(), None if wnd1 is None else wnd1.data_ptr())
    build.check(lib, rc, "window-sum kernel")
    config.record_kernel("window_sum")
    return wnd2, wnd1


def window_sums(x: torch.Tensor, th: int, tw: int, *, sq: bool = True, sums: bool = False):
    """``(sq, sums)`` of f32 planes x (C, H, W), any strides, over th × tw
    windows: ``sq`` (H', W') the window sums of Σ_c x² when asked for,
    ``sums`` (C, H', W') the per-channel window sums when asked for, None
    otherwise.

    Raises ValueError for inputs the kernel does not take (not rank 3, not
    f32, a window larger than the image, neither sum asked for)."""
    _check(x, th, tw, sq, sums)
    if x.device.type == "cuda":
        return _launch(x, th, tw, sq, sums)
    if x.device.type != "cpu":
        raise ValueError(f"no window-sum route for device {x.device}")
    out = window_sums_torch(x, th, tw, sq=sq, sums=sums)
    config.record_kernel("window_sum_torch")
    return out
