"""Plain reference of the two preprocessing chains the benchmark times.

It is written from the configuration files alone: it imports neither JAX
nor ``vacv_tpu`` nor ``vacv_tpu_torch``, and works out the crop at its top,
the resize taps, the inverse of the warp matrix and the statistics itself.

The chains (vacv's u8 semantics, ``PERF.md`` "Cells"):

* config 4: crop the (H, W, 3) u8 frame at its top, resize each channel
  plane to (oh, ow) with the half-pixel bilinear map and Q11 weights
  (vertical pass first), truncate to the u8 grid as ``floor(x + 1e-4)``
  clipped to [0, 255], lay out CHW in f32, then normalize each plane by its
  own statistics: ``(x - mean) / (std + 1e-6)``, ``std`` the population one.
* config 5: crop, then the affine warp by the inverse of the forward
  matrix (inverted in float64 and stored as float32; the source coordinate
  ``((m0 dx) + (m1 dy)) + m2`` in float32; Q11 weights ``w0 = floor((1 - a)
  2048 + 0.5) / 2048``, ``w1 = 1 - w0``; a tap outside the crop reads the
  border value 0), truncated to u8 as above, then config 4's tail.

The sums of Q11 weights times u8 taps are exact in float64, which is what
``dtype=torch.float64`` computes.  ``dtype=torch.bfloat16`` is the control:
the same steps in the precision below the configuration's float32.
"""
from __future__ import annotations

import numpy as np
import torch

Q11 = 2048.0
TRUNC_EPS = 1e-4
NORM_EPS = 1e-6


def linear_taps(n_in: int, n_out: int):
    """(start, w0, w1) numpy arrays, one entry per output index: output i
    blends inputs ``start[i]`` and ``start[i] + 1`` with Q11 weights.  The
    map is ``(i + 0.5) n_in / n_out - 0.5``; a start below 0 takes 0 with
    weight (1, 0), one at or past ``n_in - 1`` takes ``n_in - 2`` with
    (0, 1)."""
    if n_in == 1:
        zeros = np.zeros(n_out)
        return np.zeros(n_out, np.int64), np.ones(n_out), zeros
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f)
    a = f - s
    a[s < 0], s[s < 0] = 0.0, 0.0
    a[s >= n_in - 1], s[s >= n_in - 1] = 1.0, n_in - 2
    w0 = np.floor((1.0 - a) * Q11 + 0.5) / Q11
    w1 = np.floor(a * Q11 + 0.5) / Q11
    return s.astype(np.int64), w0, w1


def needed(n_in: int, n_out: int) -> np.ndarray:
    """The input indices that some output reads with a weight other than 0."""
    s, w0, w1 = linear_taps(n_in, n_out)
    idx = np.concatenate([s[w0 != 0], np.minimum(s + 1, n_in - 1)[w1 != 0]])
    return np.unique(idx)


def truncate_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(x + TRUNC_EPS), 0, 255)


def resize(planes: torch.Tensor, oh: int, ow: int, dtype=None) -> torch.Tensor:
    """(..., h, w) planes to (..., oh, ow) in ``dtype`` (by default the
    planes' own), vertical pass first, before truncation; u8 planes are
    gathered before they are widened."""
    h, w = planes.shape[-2:]
    dev, dt = planes.device, dtype or planes.dtype
    out = planes
    for dim, (n_in, n_out) in ((-2, (h, oh)), (-1, (w, ow))):
        s, w0, w1 = linear_taps(n_in, n_out)
        s = torch.from_numpy(s).to(dev)
        shape = (n_out, 1) if dim == -2 else (n_out,)
        w0 = torch.from_numpy(w0).to(dev, dt).reshape(shape)
        w1 = torch.from_numpy(w1).to(dev, dt).reshape(shape)
        nxt = torch.clamp(s + 1, max=n_in - 1)
        out = out.index_select(dim, s).to(dt) * w0 + out.index_select(dim, nxt).to(dt) * w1
    return out


def normalize(planes: torch.Tensor):
    """((x - mean) / (std + 1e-6), std) over the trailing (h, w) of each plane."""
    mean = planes.mean(dim=(-2, -1), keepdim=True)
    std = torch.sqrt(torch.square(planes - mean).mean(dim=(-2, -1), keepdim=True))
    return (planes - mean) / (std + NORM_EPS), std[..., 0, 0]


def clamp_top(top: int, height: int, crop_h: int) -> int:
    return min(max(int(top), 0), height - crop_h)


def crop_planes(frames: torch.Tensor, cfg: dict, top: int) -> torch.Tensor:
    """(N, 3, ch, cw) u8 planes of the crop of (N, H, W, 3) frames at ``top``."""
    c = cfg["crop"]
    top = clamp_top(top, frames.shape[1], c["height"])
    rows = frames[:, top:top + c["height"], c["left"]:c["left"] + c["width"], :]
    return rows.permute(0, 3, 1, 2)


def invert_affine(m) -> np.ndarray:
    """The inverse of a 2x3 forward matrix, in float64, stored as float32."""
    m = np.asarray(m, np.float64).reshape(2, 3)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    a = np.array([[m[1, 1], -m[0, 1]], [-m[1, 0], m[0, 0]]]) / det
    b = -a @ m[:, 2]
    return np.concatenate([a, b[:, None]], axis=1).astype(np.float32)


def warp_grid(minv: np.ndarray, oh: int, ow: int, device, dtype=torch.float32):
    """(floor x, floor y, w0 x, w1 x, w0 y, w1 y) of every output pixel, each
    (oh, ow): the source coordinate in ``dtype`` (float32 as configured),
    its floor as int64 and the Q11 weights in ``dtype``."""
    m = torch.from_numpy(minv.reshape(6)).to(device, dtype)
    dx = torch.arange(ow, device=device, dtype=dtype)[None, :]
    dy = torch.arange(oh, device=device, dtype=dtype)[:, None]
    grid = []
    for r in (0, 1):
        f = (m[3 * r] * dx + m[3 * r + 1] * dy) + m[3 * r + 2]
        fl = torch.floor(f)
        a = f - fl
        w0 = torch.floor((1.0 - a) * Q11 + 0.5) / Q11
        grid.append((fl.to(torch.int64), w0, 1.0 - w0))
    (sx, wx0, wx1), (sy, wy0, wy1) = grid
    return sx, sy, wx0, wx1, wy0, wy1


def warp(planes: torch.Tensor, minv: np.ndarray, oh: int, ow: int, dtype) -> torch.Tensor:
    """Bilinear warp of (N, C, h, w) u8 planes, border constant 0, before
    truncation, in ``dtype`` (float64: exact sums of the float32 weights)."""
    h, w = planes.shape[-2:]
    grid_dtype = torch.float32 if dtype == torch.float64 else dtype
    sx, sy, wx0, wx1, wy0, wy1 = warp_grid(minv, oh, ow, planes.device, grid_dtype)
    flat = planes.reshape(planes.shape[:-2] + (h * w,)).to(dtype)
    out = 0
    for tx, wx in ((sx, wx0), (sx + 1, wx1)):
        for ty, wy in ((sy, wy0), (sy + 1, wy1)):
            inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            idx = (ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)).reshape(-1)
            vals = flat.index_select(-1, idx).reshape(planes.shape[:-2] + (oh, ow))
            weight = torch.where(inside, wx.to(dtype) * wy.to(dtype), 0)
            out = out + vals * weight
    return out


def chain(frames: torch.Tensor, cfg: dict, top: int, dtype=torch.float64):
    """(output (N, 3, oh, ow) of ``dtype``, std (N, 3) of the truncated
    planes) of a configuration's chain on (N, H, W, 3) u8 frames at ``top``."""
    planes = crop_planes(frames, cfg, top)
    if cfg.get("warp"):
        wp = cfg["warp"]
        warped = warp(planes, invert_affine(wp["matrix"]), wp["height"], wp["width"], dtype)
        planes = truncate_u8(warped)
    out = cfg["out"]
    resized = truncate_u8(resize(planes, out["height"], out["width"], dtype))
    return normalize(resized)

