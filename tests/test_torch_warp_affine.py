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
