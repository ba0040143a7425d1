"""The yuv2bgr kernel's host side: the vector width its wrapper picks.

A kernel thread takes V bytes of two Y rows and of their chroma row
(``csrc/yuv2bgr.cu``); ``vector_width`` picks V from the widths, row
strides and base addresses and the threads a frame leaves, and the
kernel faults on a V the layout does not allow, so the choice is pinned
here on CPU tensors laid out as the kernel's callers lay them out.  The decode itself is held bit-exact to
the JAX package in tests/test_torch_cvt_color.py, and the kernel to its
plain version on the card in tests/test_torch_cuda.py.
"""
import re

import pytest
import torch

from vacv_tpu_torch import config
from vacv_tpu_torch.ops.cuda import yuv2bgr as yk


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


def width_of(y, vu, out_addr=0):
    h, w = y.shape
    return yk.vector_width(h, w, y.data_ptr(), y.stride(0), vu.data_ptr(), vu.stride(0), out_addr)


def stacked(h, w, pitch=None, offset=0):
    """Y and VU views of one stacked NV buffer of rows ``pitch`` bytes apart
    (``w`` by default), starting ``offset`` bytes above a 64-byte-aligned
    allocation."""
    pitch = pitch or w
    rows = h + (h + 1) // 2
    flat = torch.zeros(rows * pitch + offset, dtype=torch.uint8)
    assert flat.data_ptr() % 64 == 0
    buf = flat[offset:].view(rows, pitch)[:, :w]
    return buf[:h], buf[h:]


@pytest.mark.parametrize("h,w,v", [
    (2160, 3840, 8),    # 4K
    (1080, 1920, 8),    # the camera path and config 4's frame: 129 600 threads at 8 bytes
    (1079, 1920, 8),    # an odd height: the VU plane starts at h * w
    (720, 1280, 4),     # the tracking frame: 8 bytes leave 57 600 threads
    (288, 352, 4),      # CIF: 12 672 threads at 4 bytes
    (144, 176, 2),      # config 2's QCIF frame: 4 bytes leave 3 168 threads
    (1079, 284, 4),     # 284 is a multiple of 4, not of 8
    (215, 284, 2),      # ... and at 215 rows 4 bytes leave 7 668 threads
    (1080, 1928, 8),    # 1928 is a multiple of 8, not of 16
    (100, 1928, 4),     # ... and at 100 rows 8 bytes leave 12 050 threads
    (3, 6, 2),
    (1, 2, 2),
])
def test_vector_width_of_stacked_frames(h, w, v):
    assert width_of(*stacked(h, w)) == v


def test_a_width_is_taken_where_it_leaves_enough_threads():
    for h, w in ((2160, 3840), (1080, 1920), (720, 1280), (480, 640), (288, 352), (144, 176)):
        v = width_of(*stacked(h, w))
        threads = {u: w // u * ((h + 1) // 2) for u in yk.VECTOR_WIDTHS}
        assert v == 2 or threads[v] >= yk._MIN_THREADS[v]
        assert all(threads[u] < yk._MIN_THREADS[u] for u in yk.VECTOR_WIDTHS if u > v)


def test_a_y_view_at_an_odd_byte_offset_takes_two_bytes():
    assert width_of(*stacked(2160, 3840, offset=1)) == 2
    assert width_of(*stacked(2160, 3840, offset=8)) == 8
    assert width_of(*stacked(2160, 3840, offset=4)) == 4


@pytest.mark.parametrize("pitch,v", [(4096, 8), (3856, 8), (3848, 8), (3844, 4), (3842, 2)])
def test_strided_views_take_what_their_pitch_allows(pitch, v):
    y, vu = stacked(2160, 3840, pitch=pitch)
    assert y.stride(0) == vu.stride(0) == pitch
    assert width_of(y, vu) == v


def test_the_output_address_counts():
    y, vu = stacked(2160, 3840)
    assert width_of(y, vu, out_addr=256) == 8
    assert width_of(y, vu, out_addr=260) == 4
    assert width_of(y, vu, out_addr=258) == 2


def test_wrapper_constants_are_the_kernels():
    src = (yk.build.SRC_DIR / "yuv2bgr.cu").read_text()
    block_y = int(re.search(r"constexpr int kBlockY = (\d+);", src).group(1))
    assert yk._MAX_ROWS == 2 * block_y * 65535
    cases = {int(v) for v in re.findall(r"case (\d+):", src)}
    assert set(yk.VECTOR_WIDTHS) == cases


def test_cpu_planes_never_launch():
    y, vu = stacked(6, 8)
    k0, p0 = config.kernel_count("yuv2bgr"), config.kernel_count("yuv2bgr_torch")
    b, g, r = yk.nv_to_bgr(y, vu, is_nv12=False)
    assert b.shape == g.shape == r.shape == (6, 8)
    assert config.kernel_count("yuv2bgr") == k0
    assert config.kernel_count("yuv2bgr_torch") == p0 + 1
