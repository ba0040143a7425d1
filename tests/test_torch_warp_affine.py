"""vacv_tpu_torch.warp_affine against vacv_tpu's on the CPU.

The same seeded numpy images and matrices go through the JAX package and
through the port (the warp kernel's plain version, ``warp_planes_torch``,
on a CPU tensor).  Bars: u8 at most 1 LSB off on under 0.5% of the values;
f32 within 5e-3 absolute of the JAX package's jnp route (its Pallas warp
is only ~2^-16-relative for f32, so f32 is held to the gather route).
The JAX package sends axis-aligned matrices down its separable matmul
route, which the port does not have: those cases hold the port's gather
to it within the same bars.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu import config as jconfig
from vacv_tpu_torch import config
from vacv_tpu_torch.ops.crop import dynamic_slice
from vacv_tpu_torch.ops.cuda import warp_affine as wk
from vacv_tpu_torch.utils.fuzz import affine_matrices
from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch, warp_planes_batch_torch


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


H, W = 40, 56
OUT = (48, 36)  # (w, h)
MATRICES = {
    "rotation": np.array([[0.85, 0.05, 6.0], [-0.05, 0.85, 4.0]], np.float32),
    # Axis-aligned flip and scale (the JAX package's separable route).
    "axis_aligned": np.array([[-1.3, 0.0, 60.0], [0.0, 0.8, -3.0]], np.float32),
    "mostly_out": np.array([[0.5, 0.0, 40.0], [0.0, 0.5, 30.0]], np.float32),
}
INTERPS = [vt.INTER_LINEAR, vt.INTER_NEAREST, vt.INTER_CUBIC]
BORDERS = [vt.BORDER_CONSTANT, vt.BORDER_REPLICATE, vt.BORDER_REFLECT, vt.BORDER_WRAP,
           vt.BORDER_REFLECT_101]


def image(seed, shape=(H, W, 3), dtype=np.uint8):
    img = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    return img.astype(dtype)


def jax_warp(src, m, dsize, flags=1, border=0, bv=0.0, layout="HWC", backend="jnp", **kw):
    with jconfig.backend(backend):
        img = vc.Image(jnp.asarray(src), vc.Layout(layout))
        return np.asarray(vc.warp_affine(img, m, dsize, flags, border, bv, **kw).data)


def assert_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if got.dtype == np.uint8:
        assert d.max() <= 1 and (d > 0).mean() < 0.005, (d.max(), (d > 0).mean())
    else:
        assert d.max() <= 5e-3, d.max()


@pytest.mark.parametrize("point,angle,scale", [
    ((0, 0), 30.0, 1.0), ((28.5, 20.0), -17.0, 0.8), ((640, 360), 90.0, 1.25),
])
def test_rotation_matrix_and_inverse_are_array_equal(point, angle, scale):
    j = vc.get_rotation_matrix_2d(vc.VPoint(*point), angle, scale)
    t = vt.get_rotation_matrix_2d(vt.VPoint(*point), angle, scale)
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(vc.invert_affine(j), vt.invert_affine(t))
    for m in (*MATRICES.values(), np.zeros((2, 3), np.float32)):
        before = m.copy()
        np.testing.assert_array_equal(vc.invert_affine(m), vt.invert_affine(m))
        np.testing.assert_array_equal(m, before)  # not clobbered


@pytest.mark.parametrize("matrix", list(MATRICES))
@pytest.mark.parametrize("interp", INTERPS, ids=lambda m: m.name)
@pytest.mark.parametrize("border", BORDERS, ids=lambda b: b.name)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_warp_matches_jnp(matrix, interp, border, dtype):
    src = image(1, dtype=dtype)
    m = MATRICES[matrix]
    want = jax_warp(src, m, OUT, int(interp), int(border), 17.0)
    got = vt.warp_affine(src, m, OUT, interp, border, 17.0).numpy()
    assert_close(got, want)


@pytest.mark.parametrize("interp,border", [
    (vt.INTER_LINEAR, vt.BORDER_CONSTANT), (vt.INTER_NEAREST, vt.BORDER_CONSTANT),
    (vt.INTER_CUBIC, vt.BORDER_CONSTANT), (vt.INTER_LINEAR, vt.BORDER_REFLECT_101),
])
def test_u8_warp_matches_the_pallas_kernel(interp, border):
    """The JAX warp kernel in interpret mode (the border modes through its
    pad plan) against the port's plain version."""
    src = image(2)
    m = MATRICES["rotation"]
    before = jconfig.kernel_count("warp_affine")
    want = jax_warp(src, m, OUT, int(interp), int(border), 5.0, backend="pallas")
    assert jconfig.kernel_count("warp_affine") == before + 1
    assert_close(vt.warp_affine(src, m, OUT, interp, border, 5.0).numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("matrix", ["rotation", "axis_aligned"])
def test_transparent_and_vacv_edge_mode(dtype, matrix):
    """BORDER_TRANSPARENT is CONSTANT with the vacv skip-edge mask; the
    mask applies to linear only."""
    src = image(3, dtype=dtype)
    m = MATRICES[matrix]
    for interp in INTERPS:
        want = jax_warp(src, m, OUT, int(interp), int(vt.BORDER_TRANSPARENT), 9.0)
        got = vt.warp_affine(src, m, OUT, interp, vt.BORDER_TRANSPARENT, 9.0).numpy()
        assert_close(got, want)
        want = jax_warp(src, m, OUT, int(interp), 0, 9.0, edge_mode="vacv")
        got = vt.warp_affine(src, m, OUT, interp, 0, 9.0, edge_mode="vacv").numpy()
        assert_close(got, want)


def test_flags_inverse_map_isolated_and_vscalar():
    src = image(4)
    m = MATRICES["rotation"]
    inv = vt.invert_affine(m)
    flags = int(vt.INTER_LINEAR) | int(vt.WARP_INVERSE_MAP)
    np.testing.assert_array_equal(vt.warp_affine(src, inv, OUT, flags).numpy(),
                                  vt.warp_affine(src, m, OUT).numpy())
    assert_close(vt.warp_affine(src, inv, OUT, flags).numpy(), jax_warp(src, inv, OUT, flags))
    border = int(vt.BORDER_REFLECT) | int(vt.BORDER_ISOLATED)
    assert_close(vt.warp_affine(src, m, OUT, vt.INTER_CUBIC, border).numpy(),
                 jax_warp(src, m, OUT, int(vt.INTER_CUBIC), border))
    want = jax_warp(src, m, OUT, 1, 0, vc.VScalar(33.0, 1.0, 2.0, 3.0))
    got = vt.warp_affine(src, m, OUT, 1, 0, vt.VScalar(33.0, 1.0, 2.0, 3.0)).numpy()
    assert_close(got, want)
    assert (got[0, 0] == 33).all()  # the top-left corner maps outside the image
    with pytest.raises(NotImplementedError):
        vt.warp_affine(src, m, OUT, vt.INTER_AREA)


@pytest.mark.parametrize("layout", ["HWC", "CHW", "2-D"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float16], ids=["u8", "f32", "f16"])
def test_layouts_and_half_precision(layout, dtype):
    src = image(5, dtype=dtype)
    jl = "HWC"
    if layout == "CHW":
        src, jl = np.ascontiguousarray(src.transpose(2, 0, 1)), "CHW"
    elif layout == "2-D":
        src = np.ascontiguousarray(src[..., 1])
    m = MATRICES["rotation"]
    want = jax_warp(src, m, OUT, 1, 1, 0.0, layout=jl)
    got = vt.warp_affine(vt.Image(torch.from_numpy(src), vt.Layout(jl)), m, OUT, 1, 1)
    assert got.layout == vt.Layout(jl) and got.data.is_contiguous()
    if dtype == np.float16:
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.numpy().astype(np.float32), want.astype(np.float32),
                                   atol=0.125)  # one f16 ulp at 128..255
    else:
        assert_close(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_warp_affine_rot_with_aux_param(dtype):
    src = image(6, dtype=dtype)
    for aux, rot, scale in [((28, 20, 24, 18), 30.0, 0.9), ((0, 0, 0, 0), -12.0, 1.1)]:
        want = np.asarray(vc.warp_affine_rot(src, scale, rot, OUT, vc.VScalar(*aux)).data)
        got = vt.warp_affine_rot(src, scale, rot, OUT, vt.VScalar(*aux)).numpy()
        assert_close(got, want)


def test_torch_backend_runs_the_gather_and_matches():
    src = image(7)
    m = MATRICES["rotation"]
    with config.backend("torch"):
        a = vt.warp_affine(src, m, OUT, vt.INTER_CUBIC, vt.BORDER_WRAP).numpy()
    b = vt.warp_affine(src, m, OUT, vt.INTER_CUBIC, vt.BORDER_WRAP).numpy()
    np.testing.assert_array_equal(a, b)


def test_wrapper_batches_strided_planes_and_counts():
    """One call warps N frames of C planes read through any strides (an
    HWC batch's permuted crop view) into any strides."""
    batch = torch.from_numpy(image(8, shape=(3, H, W, 3)))
    planes = batch.permute(0, 3, 1, 2)[:, :, 2:38, 5:50]
    minv = vt.invert_affine(MATRICES["rotation"])
    k0, p0 = config.kernel_count("warp_affine"), config.kernel_count("warp_affine_torch")
    out = torch.empty((3, 30, 40, 3), dtype=torch.uint8)
    got = warp_planes_batch(planes, minv, 30, 40, out=out.permute(0, 3, 1, 2))
    assert config.kernel_count("warp_affine_torch") == p0 + 1
    assert config.kernel_count("warp_affine") == k0  # no card here
    assert got.data_ptr() == out.data_ptr()
    for i in range(3):
        want = warp_planes_batch_torch(planes[i:i + 1].contiguous(), minv, 30, 40)
        np.testing.assert_array_equal(out[i].permute(2, 0, 1).numpy(), want[0].numpy())
        crop = np.ascontiguousarray(batch[i, 2:38, 5:50].numpy())
        assert_close(out[i].numpy(), jax_warp(crop, minv, (40, 30), 1 | 16))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    planes = torch.zeros((1, 3, 8, 8), dtype=torch.uint8)
    minv = np.eye(2, 3, dtype=np.float32)
    with pytest.raises(ValueError, match="N, C"):
        warp_planes_batch(planes[0], minv, 4, 4)
    with pytest.raises(ValueError, match="uint8 or a float"):
        warp_planes_batch(planes.to(torch.int32), minv, 4, 4)
    with pytest.raises(ValueError, match="border"):
        warp_planes_batch(planes, minv, 4, 4, border=vt.BORDER_TRANSPARENT)
    with pytest.raises(ValueError, match="interpolation"):
        warp_planes_batch(planes, minv, 4, 4, interp=vt.INTER_AREA)
    with pytest.raises(ValueError, match="out must be"):
        warp_planes_batch(planes, minv, 4, 4, out=torch.empty((1, 3, 4, 5), dtype=torch.uint8))


# ---- a crop read at a top that lies on the device (config 5's moving ROI) ----

ROWS = 30  # the crop's rows in frames of H = 40
TOPS = {"inside": 4, "zero": 0, "last": H - ROWS, "negative": -3, "past the end": 25}


@pytest.mark.parametrize("top", list(TOPS))
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("layout", ["hwc", "planar"])
def test_device_top_warps_the_sliced_planes(top, dtype, layout):
    """``row0``/``rows``: the same as warping the planes cut by
    ``dynamic_slice`` at the top taken as 0 when negative (so clamped to
    ``[0, H - rows]``): one warp a call, u8 and f32, an HWC view and planes."""
    batch = torch.from_numpy(image(20, shape=(2, H, W, 3))).to(dtype)
    planes = batch.permute(0, 3, 1, 2)[..., 3:51]
    if layout == "planar":
        planes = planes.contiguous()
    minv = vt.invert_affine(MATRICES["rotation"])
    t = torch.tensor(TOPS[top], dtype=torch.int32)
    p0 = config.kernel_count("warp_affine_torch")
    got = warp_planes_batch(planes, minv, 36, 48, row0=t, rows=ROWS)
    assert config.kernel_count("warp_affine_torch") == p0 + 1
    cut = dynamic_slice(planes, 2, max(TOPS[top], 0), ROWS)
    assert cut.shape[2] == ROWS and cut.data_ptr() == planes[:, :, min(max(TOPS[top], 0),
                                                                        H - ROWS)].data_ptr()
    np.testing.assert_array_equal(got.numpy(), warp_planes_batch_torch(cut, minv, 36, 48).numpy())
    same = warp_planes_batch_torch(planes, minv, 36, 48, row0=t, rows=ROWS)
    np.testing.assert_array_equal(same.numpy(), got.numpy())


def test_device_top_checks():
    """What the wrapper refuses of a top and a crop height."""
    planes = torch.zeros((1, 3, 8, 8), dtype=torch.uint8)
    minv = np.eye(2, 3, dtype=np.float32)
    with pytest.raises(ValueError, match="together"):
        warp_planes_batch(planes, minv, 4, 4, row0=torch.tensor(1))
    with pytest.raises(ValueError, match="integer"):
        warp_planes_batch(planes, minv, 4, 4, row0=torch.tensor(1.0), rows=4)
    with pytest.raises(ValueError, match="integer"):
        warp_planes_batch(planes, minv, 4, 4, row0=torch.tensor([1, 2]), rows=4)
    with pytest.raises(ValueError, match="integer tensor"):
        warp_planes_batch(planes, minv, 4, 4, row0=3, rows=4)
    with pytest.raises(ValueError, match="does not fit"):
        warp_planes_batch(planes, minv, 4, 4, row0=torch.tensor(0), rows=9)
    ramp = torch.arange(8, dtype=torch.uint8).reshape(1, 1, 8, 1).expand(1, 3, 8, 8)
    got = warp_planes_batch(ramp, minv, 4, 4, row0=torch.tensor(3), rows=4)
    assert (got[0, :, :, 0] == torch.tensor([3, 4, 5, 6], dtype=torch.uint8)).all()


@pytest.mark.parametrize("interp", INTERPS, ids=lambda m: m.name)
@pytest.mark.parametrize("top", [0, 17, 36, -5, 500])
def test_tile_paths_at_an_int_top(interp, top):
    """``tile_paths`` with an int ``row0`` is ``tile_paths`` on the cut
    view (clamped as the kernel clamps), for HWC u8 and f32 views and
    planes, whose base addresses then move by the top's rows."""
    batch = torch.zeros((2, 180, 320, 3), dtype=torch.uint8)
    minv = vt.invert_affine(np.array([[0.9, 0.03, 4.0], [-0.03, 0.9, 2.5]], np.float32))
    for src in (batch.permute(0, 3, 1, 2)[..., 8:312], batch.permute(0, 3, 1, 2).contiguous(),
                batch.float().permute(0, 3, 1, 2)):
        cut = src.narrow(2, min(max(top, 0), 180 - 144), 144)
        want = wk.tile_paths(cut, minv, 120, 250, interp)
        assert wk.tile_paths(src, minv, 120, 250, interp, row0=top, rows=144) == want
        assert sum(want.values()) == 2 * 8 * 4


# ---- the kernel's tile decision on the host (the CUDA launch cannot run here) ----

def test_wrapper_constants_are_the_kernels():
    import re

    src = (wk.build.SRC_DIR / "warp_affine.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kTileX"]), int(consts["kTileY"]), int(consts["kGroup"])) == (
        wk.TILE_X, wk.TILE_Y, wk.GROUP)
    assert int(consts["kStageBytes"]) == wk.STAGE_BYTES
    assert int(consts["kFastLimit"]) == wk.FAST_LIMIT
    assert re.search(r"enum \{ kAuto = 0, kNoStage = 1, kEdgeOnly = 2 \}", src)
    assert wk.PATHS == ("auto", "no_stage", "edge_only")


def _hwc(n=2, h=40, w=56, c=3, dtype=torch.uint8):
    return torch.zeros((n, h, w, c), dtype=dtype).permute(0, 3, 1, 2)


def _meta(shape, strides):
    """Planes of the given shape and strides with no memory behind them."""
    return torch.empty_strided(shape, strides, dtype=torch.uint8, device="meta")


_FLAT = torch.zeros(2 * 40 * 56 * 3 + 3, dtype=torch.uint8)
# The C entry's 32-bit bound: (h - 1) sy + (w - 1) 3 + 2 < 2^31 - 1.
_ROWS_AT_BOUND = (2**31 - 2 - 2 - 3 * 99) // 300 + 1      # the last rows count under it
HWC3_CASES = {
    "config 5 crop view": (torch.zeros((2, 1440, 2560, 3), dtype=torch.uint8)
                           [:, 36:1404, 64:2496].permute(0, 3, 1, 2), vt.INTER_LINEAR, True),
    "whole frames": (_hwc(), vt.INTER_LINEAR, True),
    "odd left": (_hwc()[..., 1:], vt.INTER_LINEAR, True),
    "base 1 byte past a boundary": (_FLAT[1:1 + 2 * 40 * 56 * 3].view(2, 40, 56, 3)
                                    .permute(0, 3, 1, 2), vt.INTER_LINEAR, True),
    "one pixel": (_hwc(1, 1, 1), vt.INTER_LINEAR, True),
    "rows at the 32-bit bound": (_meta((1, 3, _ROWS_AT_BOUND, 100), (1, 1, 300, 3)),
                                 vt.INTER_LINEAR, True),
    "a row past the 32-bit bound": (_meta((1, 3, _ROWS_AT_BOUND + 1, 100), (1, 1, 300, 3)),
                                    vt.INTER_LINEAR, False),
    "planar": (_hwc().contiguous(), vt.INTER_LINEAR, False),
    "f32": (_hwc(dtype=torch.float32), vt.INTER_LINEAR, False),
    "f16": (_hwc(dtype=torch.float16), vt.INTER_LINEAR, False),
    "cubic": (_hwc(), vt.INTER_CUBIC, False),
    "nearest": (_hwc(), vt.INTER_NEAREST, False),
    "4 channels": (_hwc(c=4), vt.INTER_LINEAR, False),
    "1 channel": (_hwc(c=1), vt.INTER_LINEAR, False),
    "5 channels": (_hwc(c=5), vt.INTER_LINEAR, False),
    "3 of 4 channels": (_hwc(c=4)[:, :3], vt.INTER_LINEAR, False),
    "x stride 6": (_hwc()[..., ::2], vt.INTER_LINEAR, False),
}


@pytest.mark.parametrize("case", list(HWC3_CASES))
def test_hwc3_form_is_the_c_entrys_choice(case):
    """``hwc3_form``: u8, linear, three channels read through an HWC view
    (channel stride 1, x stride 3), every offset of a frame under 2^31 - 1,
    as ``vacv_warp_affine`` decides it (the C entry's expressions, read
    from its source)."""
    planes, interp, want = HWC3_CASES[case]
    assert wk.hwc3_form(planes, interp) is want
    src = (wk.build.SRC_DIR / "warp_affine.cu").read_text()
    assert "is_u8 && interp == kLinear && c == 3 && sc == 1 && sx == 3 && p.idx32" in src
    assert "((row0_ptr != nullptr ? rows_full : h) - 1) * sy + (w - 1) * sx + (c - 1) * sc <" in src


def tap_indices(minv, interp, h_out, w_out):
    """The tap index ranges ``warp_planes_torch`` reads for every output
    pixel, before any border rule, from its own coordinate grid: (x_min,
    x_max, y_min, y_max), each (h_out, w_out)."""
    from vacv_tpu_torch.ops.warp_affine import _grid, _to_index

    fx, fy = _grid(minv, h_out, w_out, "cpu")
    if interp == vt.INTER_NEAREST:
        tx, ty = _to_index(torch.floor(fx + 0.5)), _to_index(torch.floor(fy + 0.5))
        lo, hi = 0, 0
    else:
        tx, ty = _to_index(torch.floor(fx)), _to_index(torch.floor(fy))
        lo, hi = (-1, 2) if interp == vt.INTER_CUBIC else (0, 1)
    return (tx + lo).numpy(), (tx + hi).numpy(), (ty + lo).numpy(), (ty + hi).numpy()


@pytest.mark.parametrize("interp", INTERPS, ids=lambda m: m.name)
@pytest.mark.parametrize("h,w,h_out,w_out", [
    (40, 56, 36, 48), (215, 283, 172, 353), (37, 53, 16, 64), (9, 300, 70, 70), (1, 1, 3, 5),
    (1368, 2432, 684, 1216),
])
def test_interior_tile_boxes_hold_every_tap(interp, h, w, h_out, w_out):
    """Whenever the host twin of the kernel's rule calls a tile interior,
    every tap the plain version reads for the tile's pixels lies inside
    the tile's box, and the box inside the image: seeded scale, rotate,
    translate and flip matrices, tiles at every corner of the image."""
    matrices = affine_matrices(h * w + int(interp), h, w, h_out, w_out, 12)
    matrices += [np.array([[1, 0, 0], [0, 1, 0]], np.float32),            # taps touch every edge
                 np.array([[1, 0, 2.0], [0, 1, 2.0]], np.float32),
                 np.array([[0.25, 0, 5.0], [0, 0.25, 5.0]], np.float32),          # a small source box
                 np.array([[1, 0, w - w_out - 3.0], [0, 1, h - h_out - 3.0]], np.float32),
                 np.array([[-1, 0, w - 2.5], [0, -1, h - 2.5]], np.float32),
                 np.array([[np.nan, 0, 0], [0, 1, 0]], np.float32),
                 np.array([[1e30, 0, 0], [0, 1e-30, 5]], np.float32)]
    interior_tiles = 0
    for m in matrices:
        interior, x_lo, x_hi, y_lo, y_hi = wk.tile_boxes(m, h_out, w_out, interp, h, w)
        assert interior.shape == (-(-h_out // wk.TILE_Y), -(-w_out // wk.TILE_X))
        if not interior.any():
            continue
        tx_lo, tx_hi, ty_lo, ty_hi = tap_indices(m, interp, h_out, w_out)
        for ty, tx in zip(*np.nonzero(interior)):
            tile = (slice(ty * wk.TILE_Y, (ty + 1) * wk.TILE_Y),
                    slice(tx * wk.TILE_X, (tx + 1) * wk.TILE_X))
            box = (x_lo[ty, tx], x_hi[ty, tx], y_lo[ty, tx], y_hi[ty, tx])
            assert box[0] <= tx_lo[tile].min() and tx_hi[tile].max() <= box[1], (m, box)
            assert box[2] <= ty_lo[tile].min() and ty_hi[tile].max() <= box[3], (m, box)
            assert 0 <= box[0] and box[1] <= w - 1 and 0 <= box[2] and box[3] <= h - 1, (m, box)
            interior_tiles += 1
    if min(h, w) >= 37:
        assert interior_tiles > 0   # the sweep does reach the interior rule


def test_tile_paths_at_config_5_and_over_budget():
    """At BASELINE config 5 nearly every tile is interior (the rest touch
    the border): the cubic kernel stages them, linear reads them directly;
    a strong downscale's boxes exceed the budget and are read directly; a
    strided source is never staged."""
    batch = torch.zeros((2, 1440, 2560, 3), dtype=torch.uint8)
    crop = batch[:, 36:1404, 64:2496].permute(0, 3, 1, 2)
    minv = vt.invert_affine(np.array([[0.9, 0.03, 40.0], [-0.03, 0.9, 25.0]], np.float32))
    for src in (crop, crop.contiguous(), crop.float()):
        for interp in (vt.INTER_LINEAR, vt.INTER_CUBIC):
            paths = wk.tile_paths(src, minv, 684, 1216, interp)
            taken, other = ("staged", "direct") if interp == vt.INTER_CUBIC else ("direct", "staged")
            assert sum(paths.values()) == 2 * 19 * 43 and paths[other] == 0
            assert paths[taken] > 0.9 * sum(paths.values())
    cubic = vt.INTER_CUBIC
    assert wk.tile_paths(crop, minv, 684, 1216, cubic, path="no_stage")["staged"] == 0
    assert wk.tile_paths(crop, minv, 684, 1216, cubic, path="edge_only")["edge"] == 2 * 19 * 43
    shrink = np.array([[6.0, 0, 100], [0, 6.0, 100]], np.float32)   # 384 x 96 source px a tile
    paths = wk.tile_paths(crop, shrink, 128, 256, cubic)
    assert paths["staged"] == 0 and paths["direct"] > 0
    gaps = batch[:, :, ::2].permute(0, 3, 1, 2)[:, :2]              # HWC with x stride 6: staged
    assert wk.tile_paths(gaps, minv, 200, 300, cubic)["staged"] > 0
    strided = torch.zeros((2, 3, 400, 800), dtype=torch.uint8)[..., ::2]   # planes, x stride 2
    paths = wk.tile_paths(strided, minv, 200, 300, cubic)
    assert paths["staged"] == 0 and paths["direct"] > 0


# ---- a seeded fuzz of the plain gather against the JAX package's jnp route ----

FUZZ_SIZES = [((1, 1), (3, 2)), ((2, 3), (5, 4)), ((7, 5), (9, 11)), ((37, 53), (41, 29))]


@pytest.mark.parametrize("border", BORDERS, ids=lambda b: b.name)
@pytest.mark.parametrize("interp", INTERPS, ids=lambda m: m.name)
@pytest.mark.parametrize("size,dsize", FUZZ_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fuzz_plain_gather_matches_jnp(size, dsize, interp, border):
    """Maps that overshoot the source past both edges, every border, odd
    and tiny sizes, through ``VACV_BACKEND=jnp``'s route of the JAX
    package: u8 within 1 LSB, f32 at cosine >= 1 - 1e-4 (max-abs printed)."""
    h, w = size
    flags = int(interp) | int(vt.WARP_INVERSE_MAP)
    for i, m in enumerate(affine_matrices(h * 100 + w, h, w, dsize[1], dsize[0], 4)):
        for dtype in (np.uint8, np.float32):
            src = image(20 + i, shape=(h, w, 3), dtype=dtype)
            want = jax_warp(src, m, dsize, flags, int(border), 11.0, backend="jnp")
            got = vt.warp_affine(src, m, dsize, flags, border, 11.0).numpy()
            assert got.shape == want.shape and got.dtype == want.dtype
            d = np.abs(got.astype(np.float64) - want.astype(np.float64))
            if dtype == np.uint8:
                assert d.max() <= 1, (m, d.max())
            else:
                cos = vt.utils.compare.cosine_similarity(got, want)
                print(f"fuzz {size}->{dsize} {interp.name} {border.name} #{i}: f32 max_abs={d.max()}")
                assert cos >= 1 - 1e-4, (m, cos, d.max())
