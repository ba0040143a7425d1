"""Batched affine warp of strided planes: the warp kernel's wrapper.

The counterpart of ``vacv_tpu/ops/pallas/warp_affine.py::
warp_affine_pallas``.  ``warp_planes_batch`` warps (N, C, h, w) planes of
any strides (CHW planes, HWC frames through a permuted view, a crop view
of either) with one inverse matrix into (N, C, h_out, w_out) in the
input's type, for every interpolation (linear, nearest, cubic) and border
(CONSTANT with a border value, REPLICATE, REFLECT, REFLECT_101, WRAP), and
the reference's ``edge_mode="vacv"`` skip-edge mask.

On a CUDA tensor it launches the hand-written kernel
(``vacv_tpu_torch/csrc/warp_affine.cuh``, built from ``warp_affine.cu`` and
``warp_affine_f32.cu``), counted as ``"warp_affine"``, or raises: u8 and
f32 directly, other float types through an f32 copy and
narrowed on write-out.  On a CPU tensor it runs the plain version
``warp_planes_batch_torch``, counted as ``"warp_affine_torch"``.  On the card
the wrapper is ``prepare_warp_planes`` (the checks and the argument packing,
into a ``WarpLaunch``), then the record's ``run``; ``models/pipeline.py``
keeps such records for the batches it sees again.

``row0``/``rows`` warp a crop of ``rows`` rows whose top is a 0-d integer
tensor (a moving ROI that lies on the device): the kernel is given the
uncut frames and reads the top itself, once a block, clamped to
``[0, H - rows]`` (``dynamic_slice``'s clamp after a negative top is taken
as 0), so no gather copies the crop and the host never waits.  Every path
keeps its alignment for any top: the staged copy works out its 16-byte
skew from each tile's own first address, and takes 16-byte copies only
where the row (and plane) strides keep them aligned, element copies
otherwise, which do not depend on the base address.

The kernel works in 64 x 16 output tiles and decides per tile how to read
the source: from a copy of the tile's source box in shared memory
("staged": cubic only), straight from memory without the border rule
("direct"), or tap by tap under the border rule ("edge").  ``tile_boxes`` and
``tile_paths`` are that decision on the host, in the kernel's own float32
expressions, so that a CPU test can hold the box (a staged box that misses
a tap would be an out-of-bounds shared read) and a caller can see which
path a call takes.

A u8 linear call on three channels read through an HWC view (channel
stride 1, x stride 3) whose offsets fit 32 bits launches the kernel's
3-channel form instead (``hwc3_form`` is that choice on the host; counter
``warp.hwc3_launches``): the same tiles, paths and arithmetic, with the
taps at immediate offsets and no barrier.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device_tables import stream_key
from ...core.types import BorderMode, InterMode
from ..crop import dynamic_slice
from ..warp_affine import INTERPS, warp_epilogue, warp_planes_torch
from ...utils import trace
from . import build

_MAX_GRID_Z = 65535  # frames x channel groups
# The kernel's constants (csrc/warp_affine.cuh: kTileX, kTileY, kGroup,
# kStageBytes, kFastLimit).
TILE_X, TILE_Y, GROUP = 64, 16, 4
STAGE_BYTES = 24576
FAST_LIMIT = 1 << 22
PATHS = ("auto", "no_stage", "edge_only")  # the kernel's `mode` 0, 1, 2
_BORDERS = (BorderMode.BORDER_CONSTANT, BorderMode.BORDER_REPLICATE, BorderMode.BORDER_REFLECT,
            BorderMode.BORDER_WRAP, BorderMode.BORDER_REFLECT_101)


def tile_boxes(minv, h_out: int, w_out: int, interp, h: int, w: int):
    """The kernel's per-tile source box, for every output tile at once.

    Returns ``(interior, x_lo, x_hi, y_lo, y_hi)``, arrays over the tile
    grid (rows of tiles, tiles in a row).  Where ``interior`` is true,
    every tap that any pixel of the tile reads lies in ``[x_lo, x_hi] x
    [y_lo, y_hi]`` and that box lies inside the h x w image.  The rule:
    the source coordinate is affine and each float32 rounding step is
    monotone, so the tile's four corners bound it; their floors are grown
    by the tap support (linear and nearest reach one to the right, cubic
    one to the left and two to the right) and by one more on each side."""
    cubic = InterMode(interp) == InterMode.INTER_CUBIC
    g_lo, g_hi = (2, 3) if cubic else (1, 2)
    m = np.asarray(minv, np.float32).reshape(6)
    x0 = np.arange(0, w_out, TILE_X)
    y0 = np.arange(0, h_out, TILE_Y)
    ex = np.stack([x0, np.minimum(x0 + TILE_X, w_out) - 1]).astype(np.float32)  # (2, tiles x)
    ey = np.stack([y0, np.minimum(y0 + TILE_Y, h_out) - 1]).astype(np.float32)  # (2, tiles y)
    fdx = ex[None, :, None, :]  # corner (iy, ix), tile (ty, tx)
    fdy = ey[:, None, :, None]
    ok = np.full((y0.size, x0.size), h < FAST_LIMIT and w < FAST_LIMIT)
    boxes = []
    with np.errstate(invalid="ignore", over="ignore"):
        for row, n in ((0, w), (3, h)):
            c = (m[row] * fdx + m[row + 1] * fdy) + m[row + 2]   # float32, the kernel's order
            fl = np.floor(c).reshape(4, y0.size, x0.size)
            ok &= ((fl >= np.float32(g_lo)) & (fl <= np.float32(n - 1 - g_hi))).all(axis=0)
            safe = np.where(ok, fl, 0.0)
            boxes += [safe.min(axis=0).astype(np.int64) - g_lo,
                      safe.max(axis=0).astype(np.int64) + g_hi]
    return (ok, *boxes)


def tile_paths(planes, minv, h_out: int, w_out: int, interp=InterMode.INTER_LINEAR,
               path: str = "auto", row0: int | None = None, rows: int | None = None) -> dict:
    """How many of a call's tiles (over frames and channel groups) take
    each of the kernel's paths: ``{"staged": n, "direct": n, "edge": n}``,
    from the planes' shape, strides, type and address as the kernel
    decides it; with an int ``row0``, for the ``rows`` rows from that top,
    clamped as the kernel clamps a device top."""
    if row0 is not None:
        planes = planes.narrow(2, min(max(int(row0), 0), planes.shape[2] - rows), rows)
    n, c, h, w = planes.shape
    sn, sc, sy, sx = planes.stride()
    es = planes.element_size()
    interior, x_lo, x_hi, y_lo, y_hi = tile_boxes(minv, h_out, w_out, interp, h, w)
    counts = {"staged": 0, "direct": 0, "edge": 0}
    if path == "edge_only":
        interior = np.zeros_like(interior)
    hwc = sx != 1 and sc == 1 and sx >= c
    # Only the cubic kernel stages (16 taps a pixel); see csrc/warp_affine.cuh.
    stageable = (path == "auto" and InterMode(interp) == InterMode.INTER_CUBIC
                 and (sx == 1 or hwc))
    vec = (sy * es) % 16 == 0 and (hwc or (sc * es) % 16 == 0)
    bw, bh = x_hi - x_lo + 1, y_hi - y_lo + 1
    per = 16 // es
    for frame in range(n):
        for c0 in range(0, c, GROUP):
            cn = min(GROUP, c - c0)
            run = (bw - 1) * sx + cn if hwc else bw
            rows = bh if hwc else bh * cn
            origin = planes.data_ptr() + (frame * sn + c0 * sc + y_lo * sy + x_lo * sx) * es
            skew = (origin % 16) // es if vec else 0
            pitch = -(-(skew + run) // per) * per if vec else run
            staged = interior & stageable & (rows * pitch * es <= STAGE_BYTES)
            counts["staged"] += int(staged.sum())
            counts["direct"] += int((interior & ~staged).sum())
            counts["edge"] += int((~interior).sum())
    return counts


def hwc3_form(planes, interp=InterMode.INTER_LINEAR) -> bool:
    """Does a call on ``planes`` (as ``warp_planes_batch`` takes them: the
    full rows when a ``row0`` is given) launch the kernel's 3-channel u8
    HWC linear form (``warp_kernel_hwc3``)?  The C entry's choice, written
    out: u8, ``INTER_LINEAR``, three channels read through an HWC view
    (channel stride 1, x stride 3), and every source offset of a frame
    within 32 bits.  Every other call takes ``warp_kernel``."""
    n, c, h, w = planes.shape
    sn, sc, sy, sx = planes.stride()
    idx32 = (h - 1) * sy + (w - 1) * sx + (c - 1) * sc < 2**31 - 1
    return (planes.dtype == torch.uint8 and InterMode(interp) == InterMode.INTER_LINEAR
            and c == 3 and sc == 1 and sx == 3 and idx32)


def _check(planes, interp, border, row0=None, rows=None):
    if planes.ndim != 4:
        raise ValueError(f"warp needs (N, C, h, w) planes, got {tuple(planes.shape)}")
    if (row0 is None) != (rows is None):
        raise ValueError("give row0 and rows together")
    if row0 is not None and (not isinstance(row0, torch.Tensor) or row0.numel() != 1
                             or row0.is_floating_point() or row0.is_complex()):
        raise ValueError("runtime top must be a 1-element integer tensor")
    if rows is not None and not 1 <= int(rows) <= planes.shape[2]:
        raise ValueError(f"a crop of {rows} rows does not fit planes {tuple(planes.shape)}")
    if InterMode(interp) not in INTERPS:
        raise ValueError(f"warp interpolation must be one of {[m.name for m in INTERPS]}, "
                         f"got {interp!r}")
    if BorderMode(border) not in _BORDERS:
        raise ValueError(f"warp border must be one of {[b.name for b in _BORDERS]}, got {border!r}")
    if not (planes.dtype == torch.uint8 or planes.dtype.is_floating_point):
        raise ValueError(f"warp takes uint8 or a float type, got {planes.dtype}")


def warp_planes_batch_torch(planes, minv, h_out: int, w_out: int, *, row0=None, rows=None,
                            interp=InterMode.INTER_LINEAR,
                            border=BorderMode.BORDER_CONSTANT, border_value=0.0,
                            edge_mode="opencv"):
    """Plain PyTorch version of the kernel: the crop (``row0``/``rows``,
    as ``warp_planes_batch``), ``warp_planes_torch`` on the planes in f32,
    then the epilogue to the input's type.  Runs on any device."""
    _check(planes, interp, border, row0, rows)
    if row0 is not None:  # a gather, the top taken as 0 when negative
        planes = dynamic_slice(planes, 2, torch.clamp(row0.reshape(()), min=0), rows)
    res = warp_planes_torch(planes.to(torch.float32), minv, h_out, w_out,
                            u8=planes.dtype == torch.uint8, border_value=border_value,
                            edge_mode=edge_mode, border=border, interp=interp)
    return warp_epilogue(res, interp, planes.dtype)


class WarpLaunch(build.Launch):
    """One warp call, prepared (``prepare_warp_planes``): a ``build.Launch``
    whose arguments hold the shape and strides of the planes and of the
    output, the inverse matrix, the interpolation, the border and the path.
    Its ``run`` reads the source ``offset`` bytes past ``planes.data_ptr()``,
    writes ``out`` (a new tensor when None) and counts
    ``warp.hwc3_launches`` where the call takes the kernel's 3-channel HWC
    form (``hwc3_form``).  Its tops: none, or a tensor ``row0``."""

    __slots__ = ("hwc3",)

    def __init__(self, device, shape, dtype):
        super().__init__("warp_affine", device, shape, dtype)
        self.hwc3 = False

    def run(self, planes, row0=None, out=None, offset=0):
        """Warp into ``out`` (a new tensor when None) and return it.  Traced
        as span ``ops.warp_affine``."""
        return self._run(planes.data_ptr() + offset, row0, out)

    def _more(self, out):
        if self.hwc3:
            trace.count("warp.hwc3_launches")


def _check_out(planes, shape, out) -> None:
    if (tuple(out.shape) != tuple(shape) or out.dtype != planes.dtype
            or out.device != planes.device):
        raise ValueError(f"out must be {tuple(shape)} {planes.dtype} on {planes.device}")


def _output(planes, h_out, w_out, out):
    """``out``, checked, or a new output of the planes' type."""
    shape = (*planes.shape[:2], h_out, w_out)
    if out is None:
        return torch.empty(shape, dtype=planes.dtype, device=planes.device)
    _check_out(planes, shape, out)
    return out


def prepare_warp_planes(planes, minv, h_out: int, w_out: int, *, row0=None, rows=None,
                        interp=InterMode.INTER_LINEAR, border=BorderMode.BORDER_CONSTANT,
                        border_value=0.0, edge_mode="opencv", out=None,
                        path="auto") -> WarpLaunch:
    """``warp_planes_batch``'s work on uint8 or float32 planes on the card
    that does not depend on their data or the top's value, done ahead: the
    checks and the arguments.  ``out``, if given, sets the output strides
    the record writes.  Its ``run(planes, row0, out)`` launches it
    (``WarpLaunch``).  Raises ValueError as ``warp_planes_batch`` does, and
    for planes of another type."""
    _check(planes, interp, border, row0, rows)
    if planes.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"the warp kernel reads uint8 or float32, got {planes.dtype}")
    shape = (*planes.shape[:2], h_out, w_out)
    if out is not None:
        _check_out(planes, shape, out)
    n, c, h_full, w = planes.shape
    h = h_full if rows is None else int(rows)
    if path not in PATHS:
        raise ValueError(f"warp path must be one of {PATHS}, got {path!r}")
    if n * -(-c // GROUP) > _MAX_GRID_Z:
        raise ValueError(f"warp kernel takes at most {_MAX_GRID_Z} frame x channel groups")
    if h_out > 65535 * TILE_Y:
        raise ValueError("warp kernel output is too tall")
    if min(planes.stride()) < 0:
        raise ValueError("warp kernel needs non-negative source strides")
    dev = planes.device
    rec = WarpLaunch(dev, shape, planes.dtype)
    if math.prod(shape) == 0 or planes.numel() == 0:
        if math.prod(shape):
            raise ValueError("warp of an empty image")
        return rec
    if out is None:
        strides = (c * h_out * w_out, h_out * w_out, w_out, 1)  # a new contiguous output's
    else:
        strides = out.stride()
    m = np.asarray(minv, np.float32).reshape(6)
    rec.hwc3 = hwc3_form(planes, interp)
    args = (dev.index, stream_key(dev), None, int(planes.dtype == torch.uint8), n, c, h, w,
            *planes.stride(), None, h_out, w_out, *strides, *(float(v) for v in m),
            int(InterMode(interp)), int(BorderMode(border)), float(border_value),
            int(edge_mode == "vacv"), PATHS.index(path), None, h_full)
    rec.bind("vacv_warp_affine", args, "warp kernel", out_at=12)
    rec.top_kind(row0, len(args) - 2)
    return rec


def warp_planes_batch(planes, minv, h_out: int, w_out: int, *, row0=None, rows=None,
                      interp=InterMode.INTER_LINEAR, border=BorderMode.BORDER_CONSTANT,
                      border_value=0.0, edge_mode="opencv", out=None, path="auto"):
    """Warp (N, C, h, w) planes of any strides with the 2×3 inverse matrix
    ``minv`` into (N, C, h_out, w_out) of the planes' type.

    ``row0`` and ``rows`` warp the ``rows`` rows of (N, C, H, w) planes from
    the top ``row0`` (a 1-element integer tensor), clamped to ``[0, H -
    rows]`` after a negative top is taken as 0; on the card the top stays
    on the device (module docstring).  ``out``, if given, is written in
    place (any strides, e.g. a permuted view of an HWC tensor) and
    returned.  ``path`` (CUDA only) holds the
    kernel's paths to each other: "auto" lets each tile choose, "no_stage"
    never copies a tile's source box into shared memory, "edge_only" runs
    every tile through the per-tap border rule.  On the card: u8 and f32
    planes are ``prepare_warp_planes``, then its ``run``.  Raises ValueError
    for inputs the kernel does not take (not rank 4, an integer type other
    than uint8, an interpolation other than linear/nearest/cubic, a border
    other than CONSTANT/REPLICATE/REFLECT/WRAP/REFLECT_101, an unknown path,
    a top that is not one integer, a crop taller than the planes)."""
    kwargs = dict(row0=row0, rows=rows, interp=interp, border=border, border_value=border_value,
                  edge_mode=edge_mode)
    return build.dispatch(
        "warp_affine", planes, lambda: _warp_card(planes, minv, h_out, w_out, out, path, kwargs),
        lambda: _output(planes, h_out, w_out, out).copy_(
            warp_planes_batch_torch(planes, minv, h_out, w_out, **kwargs)))


def _warp_card(planes, minv, h_out, w_out, out, path, kwargs):
    """``warp_planes_batch`` on the card: u8 and f32 planes are
    ``prepare_warp_planes``, then its ``run``; f16, bf16 and f64 planes are
    warped in f32 and narrowed on write-out."""
    row0 = kwargs["row0"]
    if planes.dtype in (torch.uint8, torch.float32):
        return prepare_warp_planes(planes, minv, h_out, w_out, out=out, path=path,
                                   **kwargs).run(planes, row0, out)
    _check(planes, kwargs["interp"], kwargs["border"], row0, kwargs["rows"])
    out = _output(planes, h_out, w_out, out)
    wide = planes.to(torch.float32)
    return out.copy_(prepare_warp_planes(wide, minv, h_out, w_out, path=path,
                                         **kwargs).run(wide, row0))
