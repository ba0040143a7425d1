"""Plain float64 reference of face alignment, for the tests.

The input stage of ArcFace face recognition as InsightFace publishes it
(``insightface/utils/face_align.py::norm_crop``, and ``ArcFaceONNX``'s
``input_mean`` / ``input_std``): each face is warped by its similarity
transform to 112 x 112, INTER_LINEAR with a constant border 0, its planes
put in RGB order and normalized as (x - 127.5) / 127.5, through vacv's
``warp_affine_normalize`` (cv.h:172-178).  Written from that description
alone: it imports neither JAX nor any kernel of the port.

The chain, per face: the forward matrix's inverse in float64, stored as
float32; for each output pixel (dx, dy) the source coordinate ``((m0 dx) +
(m1 dy)) + m2`` in float32 and Q11 weights ``floor((1 - a) 2048 + 0.5) /
2048`` of its fraction (vacv's u8 arithmetic); the four taps, a tap outside
the frame reading 0, summed exactly (float64); truncated as ``floor(x +
1e-4)`` clipped to [0, 255]; then ``(x - mean) / (std + 1e-6)`` per output
plane.  Departures from InsightFace, both vacv's: the ``+ 1e-6`` in the
denominator; and the bilinear weights, Q11 of the exact fraction, where
OpenCV's ``warpAffine`` rounds the source coordinate to a 1/32 pixel grid
and takes Q15 weights of that, so a value may differ from OpenCV's by an
LSB or two.  The similarity matrices come from vacv's scale/rotation form
(``similarity``), in place of InsightFace's 5-point fit.
"""
from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Q11 = 2048.0
TRUNC_EPS = 1e-4
NORM_EPS = 1e-6


def similarity(cx: float, cy: float, side: float, roll: float, out: int = 112) -> np.ndarray:
    """The forward 2 x 3 float32 matrix that maps a face box of ``side``
    pixels centred on (cx, cy), rolled by ``roll`` degrees, onto an ``out``
    x ``out`` output centred on (out / 2, out / 2): vacv's scale/rotation
    form (``get_rotation_matrix_2d`` about the origin, then the translation
    that sends the centre to the output's, as ``warp_affine_rot`` does with
    its aux parameter), in float64, stored as float32."""
    s = out / side
    a = np.deg2rad(roll)
    al, be = s * np.cos(a), s * np.sin(a)
    c = out / 2
    return np.array([[al, be, c - al * cx - be * cy],
                     [-be, al, c + be * cx - al * cy]]).astype(np.float32)


def inverse(matrix) -> np.ndarray:
    """The inverse of a forward 2 x 3 matrix, float64, stored as float32."""
    m = np.asarray(matrix, np.float64).reshape(2, 3)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    a = np.array([[m[1, 1], -m[0, 1]], [-m[1, 0], m[0, 0]]]) / det
    b = -a @ m[:, 2]
    return np.concatenate([a, b[:, None]], axis=1).astype(np.float32)


def warp_face(frame: torch.Tensor, matrix, oh: int, ow: int) -> torch.Tensor:
    """(3, oh, ow) float64 of one (H, W, 3) u8 frame, before truncation:
    the bilinear warp by the inverse of ``matrix``, border 0."""
    h, w, _ = frame.shape
    m = torch.from_numpy(inverse(matrix).reshape(6)).to(frame.device)
    dx = torch.arange(ow, device=frame.device, dtype=torch.float32)[None, :]
    dy = torch.arange(oh, device=frame.device, dtype=torch.float32)[:, None]
    taps = []
    for r in (0, 1):
        f = (m[3 * r] * dx + m[3 * r + 1] * dy) + m[3 * r + 2]
        fl = torch.floor(f)
        w0 = torch.floor((1.0 - (f - fl)) * Q11 + 0.5) / Q11
        taps.append((fl.to(torch.int64), w0.to(torch.float64), (1.0 - w0).to(torch.float64)))
    (sx, wx0, wx1), (sy, wy0, wy1) = taps
    planes = frame.permute(2, 0, 1).reshape(3, h * w).to(torch.float64)
    out = torch.zeros((3, oh, ow), dtype=torch.float64, device=frame.device)
    for tx, wx in ((sx, wx0), (sx + 1, wx1)):
        for ty, wy in ((sy, wy0), (sy + 1, wy1)):
            inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            idx = (ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)).reshape(-1)
            vals = planes.index_select(1, idx).reshape(3, oh, ow)
            out = out + vals * torch.where(inside, wx * wy, 0.0)
    return out


def truncate_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(x + TRUNC_EPS), 0, 255)


def align(frames: torch.Tensor, index, matrices, dsize, mean, std, to_rgb: bool) -> torch.Tensor:
    """(K, 3, h, w) float64: face k of (N, H, W, 3) u8 ``frames`` from frame
    ``index[k]`` by the forward matrix ``matrices[k]``, ``dsize`` = (w,
    h), normalized per output plane, RGB planes with ``to_rgb``."""
    ow, oh = dsize
    mean = torch.as_tensor(mean, dtype=torch.float64).expand(3).reshape(3, 1, 1)
    std = torch.as_tensor(std, dtype=torch.float64).expand(3).reshape(3, 1, 1)
    outs = []
    for k, f in enumerate(np.asarray(index).tolist()):
        planes = truncate_u8(warp_face(frames[f], np.asarray(matrices[k]), oh, ow))
        if to_rgb:
            planes = planes.flip(0)
        outs.append((planes - mean.to(planes.device)) / (std.to(planes.device) + NORM_EPS))
    if not outs:
        return torch.empty((0, 3, oh, ow), dtype=torch.float64)
    return torch.stack(outs)
