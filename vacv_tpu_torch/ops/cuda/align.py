"""Every face of a batch of frames warped to the network's input in one
launch: the alignment kernel's wrapper (``vacv_tpu_torch/csrc/align.cu``).

``align_faces(frames, index, matrices, dsize, mean, stddev, to_rgb)`` takes
(N, H, W, 3) u8 HWC frames and a table of K faces, ``index`` (K,) int32
frame indices and ``matrices`` (K, 2, 3) float32 forward affine matrices,
and returns (K, 3, h, w) float32: face k is frame ``index[k]`` warped by
the inverse of ``matrices[k]`` to ``dsize`` = (w, h) (bilinear, u8 Q11
arithmetic, constant border 0), then ``(v - mean[c]) / (stddev[c] + 1e-6)``
for output plane c, which holds the frame's channel c, or 2 - c with
``to_rgb``.  ``mean`` and ``stddev`` are per output plane (a scalar serves
all three).  Each face is the bits of vacv's ``warp_affine_normalize`` on
its frame with its matrix, planes reversed for ``to_rgb``
(``ops/fused.py``).

On a CUDA tensor it is one launch of the kernel a call, counted as
``"align_faces"`` (``prepare_align_faces``, then the record's ``run``).  A
record is made for the frames alone and runs face tables of any K; the
host work does not depend on K and nothing is read back, so a frame index
outside [0, N) is not raised on the card: the kernel reads nothing for that
face and writes it as NaN.  K = 0 launches nothing.  On a CPU tensor it runs
the plain version ``align_faces_torch``, counted as ``"align_faces_torch"``:
one vectorized gather over all faces, which raises IndexError for such an
index.
"""
from __future__ import annotations

import ctypes

import torch

from ... import config
from ...core.device_tables import stream_key
from ...core.types import InterMode
from ..normalize import EPS, normalize_planes
from ..warp_affine import COORD_LIMIT, _quantize_q11, warp_epilogue
from ...utils import trace
from . import build
from .preprocess import _static_stats

ROUTE = "align_faces"
_MAX_FACES = 65535  # the launch's grid z
_MAX_FRAME_BYTES = 2**31 - 1  # the kernel's 32-bit tap offsets within a frame


def _check_table(frames, index, matrices) -> int:
    """K of a face table, or ValueError for one that does not go with
    ``frames``."""
    if index.ndim != 1 or index.dtype != torch.int32:
        raise ValueError(f"index must be a (K,) int32 tensor, got {tuple(index.shape)} "
                         f"{index.dtype}")
    k = index.shape[0]
    if tuple(matrices.shape) != (k, 2, 3) or matrices.dtype != torch.float32:
        raise ValueError(f"matrices must be ({k}, 2, 3) float32, got {tuple(matrices.shape)} "
                         f"{matrices.dtype}")
    if index.device != frames.device or matrices.device != frames.device:
        raise ValueError(f"frames on {frames.device}, index on {index.device}, matrices on "
                         f"{matrices.device}: all three must lie on one device")
    return k


def _check(frames, index, matrices, dsize, mean, stddev):
    """(w, h, mean, stddev) of a call, or ValueError for one the kernel
    does not take."""
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != torch.uint8:
        raise ValueError(f"frames must be (N, H, W, 3) uint8, got {tuple(frames.shape)} "
                         f"{frames.dtype}")
    if frames.shape[0] == 0 or frames.shape[1] == 0 or frames.shape[2] == 0:
        raise ValueError(f"empty frames {tuple(frames.shape)}")
    _check_table(frames, index, matrices)
    w, h = (int(v) for v in dsize)
    if w <= 0 or h <= 0:
        raise ValueError(f"dsize must be positive (w, h), got {tuple(dsize)}")
    if mean is None or stddev is None:
        raise ValueError("face alignment normalizes with static statistics: give mean and stddev")
    return w, h, _static_stats(mean), _static_stats(stddev)


def inverse_matrices(matrices: torch.Tensor) -> torch.Tensor:
    """(K, 6) float32 inverses of (K, 2, 3) forward matrices, each as
    ``ops/warp_affine.py::invert_affine`` makes it: float64, every step
    rounded, a singular matrix to zeros, then float32."""
    m00, m01, m02, m10, m11, m12 = matrices.reshape(-1, 6).to(torch.float64).unbind(1)
    det = m00 * m11 - m01 * m10
    d = torch.where(det != 0, torch.ones_like(det) / det, torch.zeros_like(det))
    a11, a22, a12, a21 = m11 * d, m00 * d, -m01 * d, -m10 * d
    b1 = -a11 * m02 - a12 * m12
    b2 = -a21 * m02 - a22 * m12
    return torch.stack([a11, a12, b1, a21, a22, b2], 1).to(torch.float32)


def align_faces_torch(frames, index, matrices, dsize, mean, stddev, to_rgb=False):
    """Plain PyTorch version of the kernel, on any device: the inverses,
    then ``warp_planes_torch``'s u8 bilinear arithmetic (constant border 0)
    for every face at once, ``warp_epilogue``, f32, planes reversed for
    ``to_rgb``, and ``normalize_planes`` with the static statistics: the
    per-face chain's operations, in its order, so its bits.  Raises
    IndexError for a frame index outside [0, N)."""
    w_out, h_out, mean, stddev = _check(frames, index, matrices, dsize, mean, stddev)
    n, h, w, _ = frames.shape
    k = index.shape[0]
    dev = frames.device
    if k == 0:
        return torch.empty((0, 3, h_out, w_out), dtype=torch.float32, device=dev)
    face = index.to(torch.int64)
    if int(face.min()) < 0 or int(face.max()) >= n:
        raise IndexError(f"a frame index outside [0, {n}): {index.tolist()}")
    m = inverse_matrices(matrices).reshape(k, 6, 1, 1).unbind(1)
    dx = torch.arange(w_out, dtype=torch.float32, device=dev)[None, None, :]
    dy = torch.arange(h_out, dtype=torch.float32, device=dev)[None, :, None]
    fx = m[0] * dx + m[1] * dy + m[2]  # (K, h_out, w_out), _grid's order
    fy = m[3] * dx + m[4] * dy + m[5]
    sxf, syf = torch.floor(fx), torch.floor(fy)
    ax, ay = fx - sxf, fy - syf

    def index_of(f):
        return torch.clamp(f, -COORD_LIMIT, COORD_LIMIT).to(torch.int64)

    sx, sy = index_of(sxf), index_of(syf)
    flat = frames.reshape(n, h * w, 3)
    base = face[:, None, None]

    def tap(tx, ty):  # (K, h_out, w_out, 3) f32, 0 outside the frame
        ok = (tx >= 0) & (tx <= w - 1) & (ty >= 0) & (ty <= h - 1)
        vals = flat[base, ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)].to(torch.float32)
        return torch.where(ok[..., None], vals, 0.0)

    wx0 = _quantize_q11(1.0 - ax)
    wx1 = 1.0 - wx0
    wy0 = _quantize_q11(1.0 - ay)
    wy1 = 1.0 - wy0
    out = (tap(sx, sy) * (wx0 * wy0)[..., None]
           + tap(sx, sy + 1) * (wx0 * wy1)[..., None]
           + tap(sx + 1, sy) * (wx1 * wy0)[..., None]
           + tap(sx + 1, sy + 1) * (wx1 * wy1)[..., None])
    planes = warp_epilogue(out, InterMode.INTER_LINEAR, torch.uint8).to(torch.float32)
    planes = planes.permute(0, 3, 1, 2)
    if to_rgb:
        planes = planes.flip(1)
    return normalize_planes(planes, mean, stddev).contiguous()


class _AlignArgs(ctypes.Structure):
    """The call's fixed arguments, made once a record and passed by address
    (``AlignArgs`` in ``csrc/align.cu``, field for field)."""

    _fields_ = [("sn", ctypes.c_longlong), ("sy", ctypes.c_longlong),
                *((k, ctypes.c_int) for k in ("n", "h", "w", "oh", "ow", "to_rgb")),
                ("mean", ctypes.c_float * 3), ("std", ctypes.c_float * 3), ("eps", ctypes.c_float)]


class AlignLaunch(build.Launch):
    """One alignment call, prepared (``prepare_align_faces``): a
    ``build.Launch`` whose fixed arguments (the frames' shape and strides,
    the output size, the statistics) are one ``_AlignArgs`` by address.
    Its ``run`` takes a face table of any K: it checks the table, puts in
    the frames', the output's, the index's and the matrices' addresses and
    K, and launches; with K = 0 it only returns the empty output."""

    __slots__ = ()

    def run(self, frames, index, matrices):
        """(K, 3, h, w) f32 of ``frames`` and the face table, a new tensor
        every call.  Traced as span ``ops.align_faces``.  ValueError for a
        table the kernel does not take."""
        span = trace.begin(self.span) if trace.ON else None
        try:
            k = _check_table(frames, index, matrices)
            if k > _MAX_FACES:
                raise ValueError(f"at most {_MAX_FACES} faces a call, got {k}")
            if not (index.is_contiguous() and matrices.is_contiguous()):
                raise ValueError("index and matrices must be contiguous")
            out = torch.empty((k, *self.shape), dtype=torch.float32, device=self.device)
            if k:
                args = list(self.args)
                args[2], args[3] = frames.data_ptr(), out.data_ptr()
                args[4], args[5], args[6] = index.data_ptr(), matrices.data_ptr(), k
                build.call(self.fn, args, self.what)
                config.record_kernel(self.route)
            return out
        finally:
            if span is not None:
                trace.end(span)


def prepare_align_faces(frames, index, matrices, dsize, mean, stddev, to_rgb=False) -> AlignLaunch:
    """``align_faces``' work on the card that does not depend on the data:
    the checks and the fixed arguments.  Its ``run(frames, index,
    matrices)`` launches it for frames of this shape, strides, type and
    device, on the CUDA stream current now, with a face table of any K.
    Raises ValueError as ``align_faces`` does, and for frames whose pixels
    are not 3 bytes apart with channels 1 apart, or whose byte offsets pass
    31 bits; its ``run`` for K above 65535 or index and matrices that are
    not contiguous."""
    w_out, h_out, mean, stddev = _check(frames, index, matrices, dsize, mean, stddev)
    n, h, w, _ = frames.shape
    sn, sy, sx, sc = frames.stride()
    if sx != 3 or sc != 1 or sn < 0 or sy < 3 * w:
        raise ValueError(f"the kernel reads HWC frames with pixels 3 bytes apart, got strides "
                         f"{frames.stride()}")
    if (h - 1) * sy + 3 * w - 1 >= _MAX_FRAME_BYTES:
        raise ValueError(f"frames of {h} rows of {sy} bytes pass the kernel's 31-bit offsets")
    dev = frames.device
    rec = AlignLaunch(ROUTE, dev, (3, h_out, w_out), torch.float32)
    fixed = _AlignArgs(sn, sy, n, h, w, h_out, w_out, int(bool(to_rgb)), mean, stddev, EPS)
    rec.held = (fixed,)
    rec.bind("vacv_align_faces", (dev.index, stream_key(dev), None, None, None, None, 0,
                                  ctypes.addressof(fixed)), "face alignment kernel")
    return rec


def align_faces(frames, index, matrices, dsize, mean, stddev, to_rgb=False):
    """(K, 3, h, w) float32: every face of the table warped and normalized
    (module docstring).  A CUDA tensor is one launch (``prepare_align_faces``,
    then its ``run``), a CPU tensor the plain version; ValueError for inputs
    the kernel does not take."""
    return build.dispatch(
        ROUTE, frames,
        lambda: prepare_align_faces(frames, index, matrices, dsize, mean, stddev,
                                    to_rgb).run(frames, index, matrices),
        lambda: align_faces_torch(frames, index, matrices, dsize, mean, stddev, to_rgb))
