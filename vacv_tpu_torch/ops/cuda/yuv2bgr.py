"""NV12/NV21 → B, G, R u8 planes: the yuv2bgr kernel's wrapper.

The counterpart of ``vacv_tpu/ops/pallas/yuv2bgr.py::nv_to_bgr_pallas``.
``nv_to_bgr`` launches the hand-written kernel
(``vacv_tpu_torch/csrc/yuv2bgr.cu``) on CUDA tensors, counted as
``"yuv2bgr"``, or raises; on CPU tensors it runs the plain version
``ops/cvt_color.py::nv_to_bgr_planes_torch``, counted as
``"yuv2bgr_torch"``.  Both are bit-exact Q7 integer math.
"""
from __future__ import annotations

import torch

from ... import config
from ...core.device_tables import stream_key
from ..cvt_color import check_nv_planes, nv_to_bgr_planes_torch
from . import build

# A thread takes two Y rows; the grid's y dimension (at most 65535) counts
# blocks of four row pairs.
_MAX_ROWS = 2 * 4 * 65535
VECTOR_WIDTHS = (8, 4)  # bytes a thread, widest first; 2 always works
# The threads a frame must leave for a width to be taken, measured on an
# H100 (PERF.md): 8 bytes beat 4 at 1080p (129 600 threads) and tied at
# 720p (57 600); 4 beat 2 at 352x288 (12 672 threads) and lost at 176x144
# (3 168).  16 bytes lost to 8 at every size up to 4K and is not built.
_MIN_THREADS = {8: 96 * 1024, 4: 8 * 1024}


def vector_width(h: int, w: int, y_addr: int, y_stride: int, vu_addr: int, vu_stride: int,
                 out_addr: int = 0) -> int:
    """The bytes of a row a kernel thread takes: the wider of 8 and 4 that
    divides the width, both row strides, the plane size ``h * w`` (where
    the G and R planes start in ``out``) and the three base addresses and
    leaves at least ``_MIN_THREADS[v]`` threads; else 2, which any planes
    allow (the width is even and the output is a fresh allocation, and at
    2 the kernel reads byte by byte).
    """
    for v in VECTOR_WIDTHS:
        if (all(x % v == 0 for x in (w, h * w, y_addr, y_stride, vu_addr, vu_stride, out_addr))
                and w // v * ((h + 1) // 2) >= _MIN_THREADS[v]):
            return v
    return 2


@build.traced("yuv2bgr")
def _launch(y_plane, vu_plane, is_nv12):
    check_nv_planes(y_plane, vu_plane)
    if y_plane.device != vu_plane.device:
        raise ValueError("Y and VU planes lie on different devices")
    if y_plane.stride(1) != 1 or vu_plane.stride(1) != 1:
        raise ValueError("yuv2bgr kernel needs row-contiguous Y and VU planes")
    h, w = y_plane.shape
    if h > _MAX_ROWS:
        raise ValueError(f"yuv2bgr kernel takes at most {_MAX_ROWS} rows")
    dev = y_plane.device
    out = torch.empty((3, h, w), dtype=torch.uint8, device=dev)
    if h and w:
        vec = vector_width(h, w, y_plane.data_ptr(), y_plane.stride(0),
                           vu_plane.data_ptr(), vu_plane.stride(0), out.data_ptr())
        args = (dev.index, stream_key(dev), y_plane.data_ptr(), y_plane.stride(0),
                vu_plane.data_ptr(), vu_plane.stride(0), out.data_ptr(), h, w, int(is_nv12), vec)
        build.call(build.entry("vacv_yuv2bgr"), args, f"yuv2bgr kernel ({vec} bytes a thread)")
        config.record_kernel("yuv2bgr")
    return out[0], out[1], out[2]


def nv_to_bgr(y_plane, vu_plane, *, is_nv12: bool):
    """(b, g, r) u8 planes from Y (h, w) + interleaved VU (⌈h/2⌉, w).

    Raises ValueError for planes the kernel does not take (not u8, an
    odd width, a VU plane shorter than ⌈h/2⌉ rows, rows that are not
    contiguous)."""
    return build.dispatch("yuv2bgr", y_plane, lambda: _launch(y_plane, vu_plane, is_nv12),
                          lambda: nv_to_bgr_planes_torch(y_plane, vu_plane, is_nv12=is_nv12))
