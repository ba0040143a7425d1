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
version, counted as ``"window_sum_torch"``.  ``launch_plan`` is the
kernel's launch on the host: its strips, threads, passes and shared
memory, so that a CPU test can hold each shape to the card's limits.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ... import config
from ...core.device_tables import stream_cached, stream_key
from . import build


# The kernel's constants (csrc/window_sum.cu: kTileX, kBatch).
TILE_X, BATCH = 64, 8
SMEM_BLOCK = 232448  # dynamic shared memory a block may opt into (H100)
SMEM_SM = 233472     # shared memory of an SM; each block also takes 1 KB


@dataclass(frozen=True)
class WindowPlan:
    """One launch of the window-sum kernel: grid (``col_tiles``,
    ``row_tiles``) of ``threads`` threads, each block a strip of 64 output
    columns and ``rows`` output rows; window rows ``kr`` and columns ``kc``
    a pass, ``passes`` passes a strip (channel groups of ``cn`` × row
    chunks × column chunks); ``smem`` bytes of dynamic shared memory, so
    ``per_sm`` blocks fit on an SM."""

    cn: int
    threads: int
    kr: int
    kc: int
    rows: int
    col_tiles: int
    row_tiles: int
    passes: int
    smem: int
    per_sm: int


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 2 if n <= 2 else 4 if n <= 4 else 8


def window_smem(nq: int, kr: int, kc: int) -> int:
    """The kernel's ``window_smem``: the ring (kr rows of 64 + kc - 1
    entries), the column sums of 8 rows and the stage of 8 output rows, in
    bytes, for ``nq`` quantities a pixel."""
    e, ncol = _pow2(nq), TILE_X + kc - 1
    pitch = (ncol + 6) // 8 * 8 + 1
    return 4 * (kr * ncol * e + BATCH * pitch * e + BATCH * nq * (TILE_X + 1))


@functools.lru_cache(maxsize=256)
def launch_plan(c: int, h: int, w: int, th: int, tw: int, *, sq: bool = True,
                sums: bool = False, sms: int = 132, rows: int | None = None) -> WindowPlan:
    """The kernel's launch for (c, h, w) planes and a th × tw window.

    Channels go in groups of up to 4 (``cn``); 128 threads a block walk up
    to 64 + 65 - 1 columns, so windows wider than 65 take 256 threads and
    passes of up to 193 columns; the ring holds as many window rows as
    shared memory allows (``kr``), taller windows take passes of ``kr``
    rows.  ``rows`` (a multiple of 8) defaults to the strip height that
    gives every SM as many blocks as fit on it at once.  The passes and the
    strips are those of a launch that writes both sums, whatever is asked
    for, so that each sum comes out the same bits either way (a sliding sum
    restarts at each strip)."""
    cn = min(c, 4)
    nq, both = int(sq) + (cn if sums else 0), 1 + cn
    threads = 128 if tw <= 128 - TILE_X + 1 else 256
    kc = min(tw, threads - TILE_X + 1)
    kr = min(th, (SMEM_BLOCK - window_smem(both, 0, kc)) // (4 * _pow2(both) * (TILE_X + kc - 1)))
    smem = window_smem(nq, kr, kc)
    per_sm = max(1, min(SMEM_SM // (smem + 1024), 2048 // threads))
    ho, wo = h - th + 1, w - tw + 1
    col_tiles = -(-wo // TILE_X)
    if rows is None:
        fit = max(1, min(SMEM_SM // (window_smem(both, kr, kc) + 1024), 2048 // threads))
        row_tiles = max(1, -(-fit * sms // col_tiles))
        rows = -(-ho // row_tiles)
    rows = max(BATCH, -(-rows // BATCH) * BATCH)
    passes = -(-c // cn) * -(-th // kr) * -(-tw // kc)
    return WindowPlan(cn, threads, kr, kc, rows, col_tiles, -(-ho // rows), passes, smem, per_sm)


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


@build.traced("window_sum")
def _launch(x, th, tw, sq, sums, rows=None):
    """One launch; ``rows`` sets the strip height in place of
    ``launch_plan``'s (a measurement's knob, not the API's)."""
    _check(x, th, tw, sq, sums)
    c, h, w = x.shape
    if min(x.stride()) < 0:
        raise ValueError("window-sum kernel needs non-negative strides")
    dev = x.device
    plan = launch_plan(c, h, w, th, tw, sq=sq, sums=sums, sms=build.sm_count(dev.index),
                       rows=rows)
    if plan.row_tiles > 65535:
        raise ValueError("window-sum kernel output is too tall")
    ho, wo = h - th + 1, w - tw + 1
    wnd2 = torch.empty((ho, wo), dtype=torch.float32, device=dev) if sq else None
    wnd1 = torch.empty((c, ho, wo), dtype=torch.float32, device=dev) if sums else None
    args = (dev.index, stream_key(dev), x.data_ptr(), c, h, w, *x.stride(), th, tw,
            None if wnd2 is None else wnd2.data_ptr(), None if wnd1 is None else wnd1.data_ptr(),
            plan.rows, plan.threads, plan.kr, plan.kc)
    build.call(build.entry("vacv_window_sum"), args, "window-sum kernel")
    config.record_kernel("window_sum")
    return wnd2, wnd1


def window_sums(x: torch.Tensor, th: int, tw: int, *, sq: bool = True, sums: bool = False):
    """``(sq, sums)`` of f32 planes x (C, H, W), any strides, over th × tw
    windows: ``sq`` (H', W') the window sums of Σ_c x² when asked for,
    ``sums`` (C, H', W') the per-channel window sums when asked for, None
    otherwise.

    Raises ValueError for inputs the kernel does not take (not rank 3, not
    f32, a window larger than the image, neither sum asked for)."""
    return build.dispatch("window_sum", x, lambda: _launch(x, th, tw, sq, sums),
                          lambda: window_sums_torch(x, th, tw, sq=sq, sums=sums))
