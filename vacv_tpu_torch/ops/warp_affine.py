"""warp_affine — inverse-mapped affine warp (vacv op #8).

The counterpart of ``vacv_tpu/ops/warp_affine.py``, with the reference's
algorithm (``warp_affine.cpp:111-169``, ``warp_affine_naive.cpp:9-106``):
invert the forward 2×3 matrix, then for every destination pixel take the
source coordinate ``(fx, fy) = M⁻¹ · (dx, dy, 1)`` in float32 and blend
its taps: bilinear (u8: Q11 weights and ``floor(x+1e-4)`` truncation;
f32: float weights), nearest (``floor(f+0.5)``) or 4×4 A=−0.75 cubic.

``warp_planes_torch`` is the plain version: a gather in torch indexing
with every border rule folded into the tap index (REPLICATE clamps,
REFLECT / REFLECT_101 / WRAP remap as ``cv::borderInterpolate`` does,
CONSTANT reads the border value for a tap outside the image).  The CUDA
kernel (``ops/cuda/warp_affine.py``) computes the same, in the same f32
order, for every matrix, interpolation and border.  The JAX package's
axis-aligned separable route and its pad plan are TPU mechanisms (the
TPU has no fast gather) and are not carried over: on the card the one
gather kernel serves an axis-aligned matrix at the same cost and needs no
pad.

Parity notes (as in the reference):

* ``invert_affine`` never clobbers the caller's matrix.
* ``edge_mode="vacv"`` gives an output pixel whose 2×2 support is not
  fully inside ``[0, w-2] × [0, h-2]`` the border value outright (the
  reference's skip-edge semantics); it applies to INTER_LINEAR only.
* ``BORDER_TRANSPARENT`` is CONSTANT with ``edge_mode="vacv"``;
  ``BORDER_ISOLATED`` is stripped.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.image import Image, as_image
from ..core.types import BorderMode, InterMode, Layout, VPoint, VScalar, VSize

_COEF_SCALE = 2048.0
# Tap coordinates are clamped to ±2^30 before the int conversion, so a
# matrix that maps far outside the image stays defined (no int overflow)
# in both the plain version and the kernel.
COORD_LIMIT = float(2**30)

INTERPS = (InterMode.INTER_LINEAR, InterMode.INTER_NEAREST, InterMode.INTER_CUBIC)


def get_rotation_matrix_2d(point: VPoint, angle: float, scale: float) -> np.ndarray:
    """2×3 rotation matrix, OpenCV-compatible (parity:
    ``WarpAffine::get_rotation_matrix_2D``, warp_affine.cpp:76-94).

    ``angle`` in degrees, positive = counter-clockwise.
    """
    a = np.deg2rad(angle)
    alpha = scale * np.cos(a)
    beta = scale * np.sin(a)
    return np.array(
        [
            [alpha, beta, (1 - alpha) * point.x - beta * point.y],
            [-beta, alpha, beta * point.x + (1 - alpha) * point.y],
        ],
        dtype=np.float32,
    )


def invert_affine(m: np.ndarray) -> np.ndarray:
    """Invert a 2×3 affine matrix in float64, returned as float32 (parity:
    warp_affine.cpp:121-133, minus the reference's in-place clobbering of
    the caller's data).  A singular matrix inverts to zeros."""
    m = np.asarray(m, dtype=np.float64).reshape(2, 3)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / det if det != 0 else 0.0
    a11 = m[1, 1] * d
    a22 = m[0, 0] * d
    a12 = -m[0, 1] * d
    a21 = -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]], dtype=np.float32)


def _quantize_q11(w):
    """Snap a weight in [0, 1] to the Q11 grid of the u8 fixed-point path
    (macro.h:25-30)."""
    return torch.floor(w * _COEF_SCALE + 0.5) / _COEF_SCALE


def _cubic_coefs(frac):
    """4-tap A=−0.75 cubic weights for fractional offset ``frac`` (OpenCV
    interpolateCubic), in the JAX package's f32 order; cubes are written
    as products, which is what ``x**3`` computes there."""
    A = -0.75
    f0 = frac + 1.0
    f2 = 1.0 - frac
    c0 = A * (f0 * f0 * f0) - 5 * A * (f0 * f0) + 8 * A * f0 - 4 * A
    c1 = (A + 2) * (frac * frac * frac) - (A + 3) * (frac * frac) + 1
    c2 = (A + 2) * (f2 * f2 * f2) - (A + 3) * (f2 * f2) + 1
    return c0, c1, c2, 1.0 - c0 - c1 - c2


def _reflect_index(t, n: int, *, include_edge: bool):
    """Reflect integer coordinates into [0, n): BORDER_REFLECT
    (``include_edge``: period 2n, edge pixel duplicated) or
    BORDER_REFLECT_101 (period 2n−2, edge not duplicated)."""
    if include_edge:
        m = torch.remainder(t, 2 * n)
        return torch.where(m >= n, 2 * n - 1 - m, m)
    if n == 1:
        return torch.zeros_like(t)
    m = torch.remainder(t, 2 * n - 2)
    return torch.where(m >= n, 2 * n - 2 - m, m)


def remap_index(t, n: int, border: BorderMode):
    """``cv::borderInterpolate``'s index map for one axis; CONSTANT clamps
    (the caller masks the tap)."""
    if border == BorderMode.BORDER_REFLECT:
        return _reflect_index(t, n, include_edge=True)
    if border == BorderMode.BORDER_REFLECT_101:
        return _reflect_index(t, n, include_edge=False)
    if border == BorderMode.BORDER_WRAP:
        return torch.remainder(t, n)
    return torch.clamp(t, 0, n - 1)  # REPLICATE, and CONSTANT before its mask


def _grid(minv, h_out: int, w_out: int, device):
    """The f32 source coordinates (fx, fy), each (h_out, w_out), computed
    as ``((m0·dx) + (m1·dy)) + m2``."""
    m = torch.from_numpy(np.asarray(minv, dtype=np.float32).reshape(6).copy())
    dx = torch.arange(w_out, dtype=torch.float32, device=device)[None, :]
    dy = torch.arange(h_out, dtype=torch.float32, device=device)[:, None]
    m = [m[i].to(device) for i in range(6)]
    fx = m[0] * dx + m[1] * dy + m[2]
    fy = m[3] * dx + m[4] * dy + m[5]
    return fx, fy


def _to_index(f):
    return torch.clamp(f, -COORD_LIMIT, COORD_LIMIT).to(torch.int64)


def warp_planes_torch(planes, minv, h_out: int, w_out: int, *, u8: bool,
                      border_value: float, edge_mode: str = "opencv",
                      border=BorderMode.BORDER_CONSTANT,
                      interp=InterMode.INTER_LINEAR):
    """Warp (..., h_in, w_in) f32 planes with inverse matrix ``minv``;
    f32 out, before the u8 epilogue (the counterpart of ``_warp_planes``).

    ``edge_mode``: ``"opencv"`` (each tap reads the border value when
    outside the image) or ``"vacv"`` (INTER_LINEAR only: an output pixel
    whose 2×2 support leaves the image gets the border value).
    ``border``: CONSTANT, or a coordinate-remap mode (REPLICATE, REFLECT,
    REFLECT_101, WRAP).  ``u8`` selects the Q11 bilinear weights.
    """
    h_in, w_in = planes.shape[-2], planes.shape[-1]
    dev = planes.device
    border = BorderMode(border)
    interp = InterMode(interp)
    fx, fy = _grid(minv, h_out, w_out, dev)
    sxf, syf = torch.floor(fx), torch.floor(fy)
    ax, ay = fx - sxf, fy - syf
    sx, sy = _to_index(sxf), _to_index(syf)

    flat = planes.reshape(planes.shape[:-2] + (h_in * w_in,))
    bv = torch.tensor(float(border_value), dtype=torch.float32, device=dev)

    def tap(tx, ty):
        idx = (remap_index(ty, h_in, border) * w_in + remap_index(tx, w_in, border)).reshape(-1)
        vals = flat.index_select(-1, idx).reshape(planes.shape[:-2] + (h_out, w_out))
        if border != BorderMode.BORDER_CONSTANT:
            return vals  # the remapped index is the border rule
        ok = (tx >= 0) & (tx <= w_in - 1) & (ty >= 0) & (ty <= h_in - 1)
        return torch.where(ok, vals, bv)

    if interp == InterMode.INTER_NEAREST:
        # OpenCV's fixed-point nearest rounds half up ((X0 + 512) >> 10).
        return tap(_to_index(torch.floor(fx + 0.5)), _to_index(torch.floor(fy + 0.5)))

    if interp == InterMode.INTER_CUBIC:
        cx, cy = _cubic_coefs(ax), _cubic_coefs(ay)
        out = None
        for i in range(4):
            row = tap(sx - 1, sy - 1 + i) * cx[0]
            for j in range(1, 4):
                row = row + tap(sx - 1 + j, sy - 1 + i) * cx[j]
            out = row * cy[0] if out is None else out + row * cy[i]
        return out

    if u8:
        # cbuf[0] = SAT(round((1-f)*2048)); cbuf[1] = 2048 - cbuf[0]
        # (warp_affine_naive.cpp:31-41).
        wx0 = _quantize_q11(1.0 - ax)
        wx1 = 1.0 - wx0
        wy0 = _quantize_q11(1.0 - ay)
        wy1 = 1.0 - wy0
    else:
        wx0, wx1 = 1.0 - ax, ax
        wy0, wy1 = 1.0 - ay, ay
    out = (
        tap(sx, sy) * (wx0 * wy0)
        + tap(sx, sy + 1) * (wx0 * wy1)
        + tap(sx + 1, sy) * (wx1 * wy0)
        + tap(sx + 1, sy + 1) * (wx1 * wy1)
    )
    if edge_mode == "vacv":
        full = (sx >= 0) & (sx < w_in - 1) & (sy >= 0) & (sy < h_in - 1)
        out = torch.where(full, out, bv)
    return out


def warp_epilogue(out: torch.Tensor, interp, dtype: torch.dtype) -> torch.Tensor:
    """f32 warp result → ``dtype``: u8 linear truncates as
    ``clip(floor(x+1e-4), 0, 255)`` (Q22 parity, warp_affine_naive.cpp:
    50-54), u8 nearest/cubic round half up like OpenCV's saturate_cast;
    float types are narrowed."""
    if dtype == torch.uint8:
        eps = 1e-4 if InterMode(interp) == InterMode.INTER_LINEAR else 0.5
        return torch.clamp(torch.floor(out + eps), 0, 255).to(torch.uint8)
    return out.to(dtype)


def warp_affine(
    src,
    M,
    dsize: VSize | tuple,
    flags: InterMode | int = InterMode.INTER_LINEAR,
    border_mode: BorderMode | int = BorderMode.BORDER_CONSTANT,
    border_value: VScalar | float = 0.0,
    edge_mode: str = "opencv",
) -> Image:
    """Affine warp (parity: ``va_cv::warp_affine``, cv.h:118-122).

    ``M`` is the *forward* 2×3 matrix (host-side numpy / list); pass
    ``flags | WARP_INVERSE_MAP`` if it is already the inverse.
    ``edge_mode="vacv"`` reproduces the reference's skip-edge-pixels
    semantics instead of OpenCV's per-tap border blending.  HWC, CHW and
    2-D images keep their layout; u8 and f32 stay, other float types are
    warped in f32 and narrowed on write-out.

    Under the ``auto`` backend the warp goes through the kernel's wrapper
    (``ops/cuda/warp_affine.py``: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor); under ``torch`` it runs
    ``warp_planes_torch`` on any device.
    """
    from .cuda.warp_affine import warp_planes_batch, warp_planes_batch_torch

    img = as_image(src)
    if isinstance(dsize, tuple):
        dsize = VSize(*dsize)
    flags = int(flags)
    inverse = bool(flags & InterMode.WARP_INVERSE_MAP)
    interp = InterMode(flags & ~int(InterMode.WARP_INVERSE_MAP))
    if interp not in INTERPS:
        raise NotImplementedError("warp_affine supports INTER_LINEAR/INTER_NEAREST/INTER_CUBIC")
    # BORDER_ISOLATED only matters for ROI submats (none here); strip it.
    border = BorderMode(int(border_mode) & ~int(BorderMode.BORDER_ISOLATED))
    if border == BorderMode.BORDER_TRANSPARENT:
        # cv::BORDER_TRANSPARENT leaves outlier pixels unwritten: on a fresh
        # dst that is the reference's skip-and-leave semantics.
        border, edge_mode = BorderMode.BORDER_CONSTANT, "vacv"
    bv = border_value.v0 if isinstance(border_value, VScalar) else float(border_value)
    minv = np.asarray(M, dtype=np.float32).reshape(2, 3)
    if not inverse:
        minv = invert_affine(minv)

    data = img.data
    hwc = data.ndim == 3 and img.layout == Layout.HWC
    if data.ndim == 2:
        planes = data[None]
    elif hwc:
        planes = data.permute(2, 0, 1)
    else:
        planes = data
    c = planes.shape[0]
    # The output is allocated in the caller's layout and written through
    # a (1, C, h, w) view of it: no transpose afterwards.
    if data.ndim == 2:
        out = torch.empty((dsize.h, dsize.w), dtype=data.dtype, device=data.device)
        view = out[None, None]
    elif hwc:
        out = torch.empty((dsize.h, dsize.w, c), dtype=data.dtype, device=data.device)
        view = out.permute(2, 0, 1)[None]
    else:
        out = torch.empty((c, dsize.h, dsize.w), dtype=data.dtype, device=data.device)
        view = out[None]
    kw = dict(interp=interp, border=border, border_value=bv, edge_mode=edge_mode)
    if config.use_fused():
        warp_planes_batch(planes[None], minv, dsize.h, dsize.w, out=view, **kw)
    else:
        view.copy_(warp_planes_batch_torch(planes[None], minv, dsize.h, dsize.w, **kw))
    return img.with_data(out)


def warp_affine_rot(
    src,
    scale: float,
    rot: float,
    dsize: VSize | tuple,
    aux_param: VScalar = VScalar(),
    flags: InterMode | int = InterMode.INTER_LINEAR,
    border_mode: BorderMode | int = BorderMode.BORDER_CONSTANT,
    border_value: VScalar | float = 0.0,
) -> Image:
    """Scale/rotation form with aux-param recentring (parity:
    ``va_cv::warp_affine`` overload, warp_affine.cpp:96-109: the
    translation column is overwritten so that source point
    ``(aux.v0, aux.v1)`` lands on destination ``(aux.v2, aux.v3)``)."""
    m = get_rotation_matrix_2d(VPoint(0, 0), rot, scale)
    m[0, 2] = aux_param.v2 - m[0, 0] * aux_param.v0 - m[0, 1] * aux_param.v1
    m[1, 2] = aux_param.v3 - m[1, 0] * aux_param.v0 - m[1, 1] * aux_param.v1
    return warp_affine(src, m, dsize, flags, border_mode, border_value)
