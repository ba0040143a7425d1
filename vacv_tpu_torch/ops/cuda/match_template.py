"""Valid 2-D cross-correlation summed over channels: the correlation
kernel's wrapper.

The counterpart of ``vacv_tpu/ops/pallas/match_template.py::corr_pallas``.
``corr_planes`` takes a (C, H, W) f32 image of any strides and a (C, th,
tw) f32 template and returns the (H-th+1, W-tw+1) f32 response
``out[y, x] = Σ_c Σ_i Σ_j img[c, y+i, x+j] · k[c, i, j]``, for any C, th
and tw.

On a CUDA tensor it launches the hand-written kernel
(``vacv_tpu_torch/csrc/match_template.cu``), counted as ``"match_corr"``,
or raises; on a CPU tensor it runs the plain version ``corr_planes_torch``
(``torch.nn.functional.conv2d`` in f32), counted as ``"match_corr_torch"``.

The kernel gives each 32 × 128 output tile one block; where the tiles are
too few to keep every SM busy it splits the channels over several blocks
of a tile and sums their partials in a second launch (``split_plan``).
"""
from __future__ import annotations

import torch

from ... import config
from ...core.device_tables import stream_key
from . import build

TILE_H, TILE_W = 32, 128  # the kernel's output tile (csrc/match_template.cu)
BLOCKS_PER_SM = 4         # blocks an SM should see before channels are split


def _check(img, k):
    if img.ndim != 3 or k.ndim != 3:
        raise ValueError(f"correlation needs (C, H, W) and (C, th, tw), got "
                         f"{tuple(img.shape)} and {tuple(k.shape)}")
    if img.dtype != torch.float32 or k.dtype != torch.float32:
        raise ValueError(f"correlation takes float32, got {img.dtype} and {k.dtype}")
    c, h, w = img.shape
    kc, th, tw = k.shape
    if kc != c or not (1 <= th <= h and 1 <= tw <= w):
        raise ValueError(f"template {tuple(k.shape)} does not fit image {tuple(img.shape)}")
    if img.device != k.device:
        raise ValueError("image and template lie on different devices")


def corr_planes_torch(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``conv2d`` (a cross-correlation) in f32 with
    one output channel.  Runs on any device; on a card, turn TF32 off
    (``torch.backends.cudnn.allow_tf32``) for f32 results.  On the CPU it
    runs without oneDNN, whose f32 convolution was 2.1e-5 of the largest
    response off the float64 one at a 48×48×3 template (JAX's
    2.7e-7)."""
    _check(img, k)
    with torch.backends.mkldnn.flags(enabled=False):
        return torch.nn.functional.conv2d(img[None], k[None])[0, 0]


def split_plan(h_out: int, w_out: int, c: int, sms: int) -> int:
    """How many blocks share the channels of one output tile: one where
    the tiles give every SM ``BLOCKS_PER_SM`` blocks, else enough (up to
    one channel a block) to come close."""
    tiles = -(-h_out // TILE_H) * -(-w_out // TILE_W)
    splits = max(1, min(c, -(-BLOCKS_PER_SM * sms // tiles)))
    per = -(-c // splits)
    return -(-c // per)  # no split left empty


@build.traced("match_corr")
def _launch(img, k):
    _check(img, k)
    c, h, w = img.shape
    _, th, tw = k.shape
    dev = img.device
    h_out, w_out = h - th + 1, w - tw + 1
    k = k.contiguous()
    splits = split_plan(h_out, w_out, c, build.sm_count(dev.index))
    # One buffer for the splits' partials; the kernel sums them into the
    # first slice, which is the response.
    out = torch.empty((splits, h_out, w_out), dtype=torch.float32, device=dev)
    args = (dev.index, stream_key(dev), img.data_ptr(), c, h, w, *img.stride(), k.data_ptr(),
            th, tw, out.data_ptr(), splits)
    build.call(build.entry("vacv_match_corr"), args, "correlation kernel")
    config.record_kernel("match_corr")
    return out[0]


def corr_planes(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation of a (C, H, W) f32 image (any strides) with
    a (C, th, tw) f32 template, summed over channels.

    Raises ValueError for inputs the kernel does not take (not rank 3, not
    f32, a template larger than the image or with another channel
    count)."""
    return build.dispatch("match_corr", img, lambda: _launch(img, k),
                          lambda: corr_planes_torch(img, k))
