"""resize — bilinear / bicubic / nearest / area / lanczos4 (vacv op #5).

The counterpart of ``vacv_tpu/ops/resize.py``.  Separable resampling is
a pair of dense matrix products over channel planes:

    dst = W_y @ src @ W_xᵀ

with ``W_y: (h_out, h_in)`` and ``W_x: (w_out, w_in)`` holding the
per-output-row / per-output-column interpolation weights.  The weight
builders below are numpy and are copies of the JAX package's, so the two
packages resample with array-equal weights (the tests pin this):

* bilinear: half-pixel mapping ``(d + 0.5) * scale - 0.5``, edge clamp
  to ``[0, n-2]`` with weight collapse (``resize_naive.cpp:20-53``);
  u8 inputs use the Q11 (×2048) quantized weights of the fixed-point
  path (``resize_naive.cpp:34-35,61-64``).
* bicubic: A = −0.75 with the reference's boundary folding of
  out-of-range taps (``resize_naive.cpp:130-185``).
* nearest / area / lanczos4 follow OpenCV semantics (the reference
  forwards these modes to OpenCV, ``resize.cpp:46-49``).

The products go through ``torch.matmul`` in float32; the fused
crop→resize→normalize route has its own kernel (``ops/cuda/preprocess.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device_tables import stream_cached
from ..core.image import Image, as_image
from ..core.types import InterMode, Layout, VSize

# Q11 fixed-point scale used by the reference's u8 kernels
# (resize_naive.cpp:34, resize_neon.cpp:14-15).
_COEF_SCALE = 2048.0


def _linear_weights(n_in: int, n_out: int, quantize: bool) -> np.ndarray:
    """Dense (n_out, n_in) bilinear weight matrix.

    Mapping and edge handling per resize_naive.cpp:20-53.  With
    ``quantize`` the two tap weights are snapped to the Q11 grid the u8
    fixed-point kernel uses.
    """
    if n_in == 1:
        return np.ones((n_out, 1), dtype=np.float32)
    scale = n_in / n_out
    d = np.arange(n_out, dtype=np.float64)
    f = (d + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    f[s < 0] = 0.0
    s[s < 0] = 0
    f[s >= n_in - 1] = 1.0
    s[s >= n_in - 1] = n_in - 2

    w0 = 1.0 - f
    w1 = f
    if quantize:
        w0 = np.floor(w0 * _COEF_SCALE + 0.5) / _COEF_SCALE
        w1 = np.floor(w1 * _COEF_SCALE + 0.5) / _COEF_SCALE
    W = np.zeros((n_out, n_in), dtype=np.float32)
    W[d.astype(np.int64), s] = w0
    W[d.astype(np.int64), s + 1] += w1
    return W


def _cubic_kernel(fx: np.ndarray) -> np.ndarray:
    """4 tap weights for fractional offset ``fx`` (A=-0.75 kernel,
    resize_naive.cpp:130-141).  Returns shape (len(fx), 4)."""
    A = -0.75
    fx0 = fx + 1.0
    fx1 = fx
    fx2 = 1.0 - fx
    c0 = A * fx0**3 - 5 * A * fx0**2 + 8 * A * fx0 - 4 * A
    c1 = (A + 2) * fx1**3 - (A + 3) * fx1**2 + 1
    c2 = (A + 2) * fx2**3 - (A + 3) * fx2**2 + 1
    c3 = 1.0 - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) bicubic weight matrix with the reference's
    boundary folding (resize_naive.cpp:143-185)."""
    if n_in < 4:
        # The reference's cubic path assumes >=4 taps fit; degrade to
        # linear exactly like its OpenCV fallback would interpolate.
        return _linear_weights(n_in, n_out, quantize=False)
    scale = n_in / n_out
    d = np.arange(n_out, dtype=np.float64)
    f = np.float32((d + 0.5) * scale - 0.5)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)

    alpha = _cubic_kernel(f).astype(np.float32)  # (n_out, 4)
    sx = s.copy()

    # Fold out-of-range taps into the edge, per cubic_coeffs_naive.
    m = sx <= -1
    if m.any():
        a = alpha[m]
        alpha[m] = np.stack(
            [1.0 - a[:, 3], a[:, 3], np.zeros_like(a[:, 0]), np.zeros_like(a[:, 0])],
            axis=-1,
        )
        sx[m] = 1
    m = s == 0
    if m.any():
        a = alpha[m]
        alpha[m] = np.stack(
            [a[:, 0] + a[:, 1], a[:, 2], a[:, 3], np.zeros_like(a[:, 0])], axis=-1
        )
        sx[m] = 1
    m = s == n_in - 2
    if m.any():
        a = alpha[m]
        alpha[m] = np.stack(
            [np.zeros_like(a[:, 0]), a[:, 0], a[:, 1], a[:, 2] + a[:, 3]], axis=-1
        )
        sx[m] = n_in - 3
    m = s >= n_in - 1
    if m.any():
        a = alpha[m]
        alpha[m] = np.stack(
            [np.zeros_like(a[:, 0]), np.zeros_like(a[:, 0]), a[:, 0], 1.0 - a[:, 0]],
            axis=-1,
        )
        sx[m] = n_in - 3

    W = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    for t in range(4):
        np.add.at(W, (rows, sx - 1 + t), alpha[:, t])
    return W


def _lanczos4_weights(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) Lanczos-4 weight matrix (OpenCV
    INTER_LANCZOS4 semantics: 8 taps of sinc(x)·sinc(x/4), normalized
    to unit sum, taps clamped to the image).  The reference forwards
    this mode to OpenCV (resize.cpp:46-49); here it is just another
    weight matrix for the same two-matmul resampler."""
    if n_in < 8:
        return _cubic_weights(n_in, n_out)
    scale = n_in / n_out
    d = np.arange(n_out, dtype=np.float64)
    f = np.float32((d + 0.5) * scale - 0.5)
    s = np.floor(f).astype(np.int64)
    frac = (f - s).astype(np.float64)

    W = np.zeros((n_out, n_in), dtype=np.float64)
    taps = np.arange(-3, 5)  # 8 taps: s-3 .. s+4
    for k in taps:
        x = k - frac  # distance from the sample point
        w = np.sinc(x) * np.sinc(x / 4.0)
        w[np.abs(x) >= 4] = 0.0
        cols = np.clip(s + k, 0, n_in - 1)
        np.add.at(W, (np.arange(n_out), cols), w)
    W /= W.sum(axis=1, keepdims=True)
    return W.astype(np.float32)


def _nearest_weights(n_in: int, n_out: int) -> np.ndarray:
    """One-hot (n_out, n_in) nearest-neighbour matrix (OpenCV mapping:
    ``sx = min(floor(dx * scale), n_in - 1)``)."""
    scale = n_in / n_out
    s = np.minimum(np.floor(np.arange(n_out) * scale).astype(np.int64), n_in - 1)
    W = np.zeros((n_out, n_in), dtype=np.float32)
    W[np.arange(n_out), s] = 1.0
    return W


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) box-average matrix (OpenCV INTER_AREA downscale:
    each output pixel averages the box ``[d*scale, (d+1)*scale)`` with
    fractional edge coverage).  For upscale this degrades to bilinear,
    matching OpenCV's behaviour."""
    if n_out >= n_in:
        return _linear_weights(n_in, n_out, quantize=False)
    scale = n_in / n_out
    W = np.zeros((n_out, n_in), dtype=np.float64)
    for d in range(n_out):
        lo = d * scale
        hi = (d + 1) * scale
        i0 = int(np.floor(lo))
        i1 = int(np.ceil(hi))
        for i in range(i0, min(i1, n_in)):
            cover = min(hi, i + 1) - max(lo, i)
            if cover > 0:
                W[d, i] = cover / scale
    return W.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _weight_matrices(
    h_in: int, w_in: int, h_out: int, w_out: int, mode: int, quantize: bool
):
    """Cached (W_y, W_x) numpy weight matrices for a resize config."""
    mode = InterMode(mode)
    if mode == InterMode.INTER_LINEAR:
        wy = _linear_weights(h_in, h_out, quantize)
        wx = _linear_weights(w_in, w_out, quantize)
    elif mode == InterMode.INTER_CUBIC:
        wy = _cubic_weights(h_in, h_out)
        wx = _cubic_weights(w_in, w_out)
    elif mode == InterMode.INTER_NEAREST:
        wy = _nearest_weights(h_in, h_out)
        wx = _nearest_weights(w_in, w_out)
    elif mode == InterMode.INTER_AREA:
        wy = _area_weights(h_in, h_out)
        wx = _area_weights(w_in, w_out)
    elif mode == InterMode.INTER_LANCZOS4:
        wy = _lanczos4_weights(h_in, h_out)
        wx = _lanczos4_weights(w_in, w_out)
    else:
        raise NotImplementedError(
            f"resize mode {mode!r} not supported; supported modes are "
            "INTER_LINEAR, INTER_CUBIC, INTER_NEAREST, INTER_AREA and "
            "INTER_LANCZOS4.  The nearest workaround for other modes "
            "is INTER_LINEAR (the reference's own default fallback, "
            "resize.cpp:46-49)."
        )
    return wy, wx


@stream_cached(maxsize=256)
def _device_weights(h_in: int, w_in: int, h_out: int, w_out: int, mode: int, quantize: bool,
                    device: torch.device):
    """(W_y, W_xᵀ) of a resize config as tensors on ``device``, copied
    there once for each CUDA stream (``core/device_tables.py``): a call
    reuses them instead of uploading the host matrices again."""
    wy, wx = _weight_matrices(h_in, w_in, h_out, w_out, mode, quantize)
    return torch.from_numpy(wy).to(device), torch.from_numpy(wx).to(device).T


def resize_planes(planes, h_out: int, w_out: int, mode: InterMode, *, u8: bool):
    """Resize (..., h, w) float32 channel planes.  Returns float32.

    ``u8`` selects the Q11-quantized bilinear weights so the result
    matches the reference's fixed-point u8 kernel before truncation.
    The pass order that costs fewer multiply-adds goes first.
    """
    h_in, w_in = planes.shape[-2], planes.shape[-1]
    if (h_in, w_in) == (h_out, w_out):
        # Same-size: memcpy shortcut (resize.cpp:58-61).
        return planes
    quantize = bool(u8) and mode == InterMode.INTER_LINEAR
    wy_t, wx_t = _device_weights(h_in, w_in, h_out, w_out, int(mode), quantize, planes.device)
    cost_h_first = h_out * h_in * w_in + w_out * w_in * h_out
    cost_w_first = w_out * w_in * h_in + h_out * h_in * w_out
    if cost_h_first <= cost_w_first:
        return torch.matmul(torch.matmul(wy_t, planes), wx_t)
    return torch.matmul(wy_t, torch.matmul(planes, wx_t))


def _resolve_dsize(h_in, w_in, dsize, fx, fy):
    w_out = dsize.w if dsize is not None else 0
    h_out = dsize.h if dsize is not None else 0
    if w_out <= 0 or h_out <= 0:
        if fx <= 0 or fy <= 0:
            raise ValueError("resize needs dsize or positive fx/fy")
        w_out = int(round(w_in * fx))
        h_out = int(round(h_in * fy))
    return h_out, w_out


def u8_eps(mode: InterMode) -> float:
    """The epsilon of the u8 epilogue ``clip(floor(x + eps), 0, 255)``.

    Linear: fixed-point parity — the accumulated Q22 value is truncated
    (``>> 22`` on non-negative data == floor); a small epsilon absorbs
    float32 rounding of exactly-representable sums.  Other modes have
    no vacv fixed-point kernel (the reference forwards them to OpenCV),
    so they round half up like ``cv::resize``."""
    return 1e-4 if mode == InterMode.INTER_LINEAR else 0.5


def u8_epilogue(out: torch.Tensor, mode: InterMode) -> torch.Tensor:
    """Float resize result → the u8 grid, still as float32."""
    return torch.clamp(torch.floor(out + u8_eps(mode)), 0, 255)


def resize(
    src,
    dsize: VSize | tuple | None,
    fx: float = 0.0,
    fy: float = 0.0,
    interpolation: InterMode | int = InterMode.INTER_LINEAR,
) -> Image:
    """Resize an image (parity: ``va_cv::resize``, cv.h:85-87).

    Accepts an ``Image`` or raw tensor / array (assumed HWC).  u8 input
    yields u8 output via truncation exactly like the fixed-point
    reference kernel (``>> 22``, resize_naive.cpp:61-64); float input
    stays float.
    """
    img = as_image(src)
    if isinstance(dsize, tuple):
        dsize = VSize(*dsize)
    mode = InterMode(interpolation)
    h_out, w_out = _resolve_dsize(img.h, img.w, dsize, fx, fy)

    data = img.data
    is_u8 = data.dtype == torch.uint8
    squeeze = data.ndim == 2
    if squeeze:
        planes = data[None]  # (1, h, w)
    elif img.layout == Layout.HWC:
        planes = data.permute(2, 0, 1)
    else:
        planes = data

    out = resize_planes(
        planes.to(torch.float32), h_out, w_out, mode, u8=is_u8
    )
    if is_u8:
        out = u8_epilogue(out, mode).to(torch.uint8)
    elif data.dtype != torch.float32:
        # half-precision inputs: accumulate in f32, narrow on write-out
        out = out.to(data.dtype)

    if squeeze:
        out = out[0]
    elif img.layout == Layout.HWC:
        out = out.permute(1, 2, 0).contiguous()
    return img.with_data(out)
