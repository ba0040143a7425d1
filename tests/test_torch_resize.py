"""vacv_tpu_torch resize against vacv_tpu: weight builders, tap tables, resize.

The weight builders are numpy copies and must stay array-equal to the
reference's.  The fused kernel's tap tables must reconstruct the JAX
kernel's dense resize weights (``_resize_weights``) exactly: that is how
the reference's weights carry across to the CUDA kernel.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu.ops.pallas.preprocess import _resize_weights as j_resize_weights
from vacv_tpu_torch.ops.cuda.preprocess import dense_from_taps, tap_table
from vacv_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


jr = importlib.import_module("vacv_tpu.ops.resize")
tr = importlib.import_module("vacv_tpu_torch.ops.resize")

SIZES = [(1, 5), (2, 7), (3, 8), (5, 5), (7, 3), (8, 8), (64, 17),
         (17, 64), (1036, 224), (1792, 224), (144, 224), (360, 96)]


@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_weight_builders_array_equal(n_in, n_out):
    for q in (False, True):
        np.testing.assert_array_equal(
            jr._linear_weights(n_in, n_out, q), tr._linear_weights(n_in, n_out, q))
    for name in ("_cubic_weights", "_nearest_weights", "_area_weights",
                 "_lanczos4_weights"):
        np.testing.assert_array_equal(
            getattr(jr, name)(n_in, n_out), getattr(tr, name)(n_in, n_out),
            err_msg=name)


@pytest.mark.parametrize("interp", ["linear", "cubic", "nearest"])
@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_tap_table_reconstructs_reference_weights(interp, n_in, n_out):
    starts, weights = tap_table(n_in, n_out, interp)
    k = weights.shape[1]
    assert k <= {"linear": 2, "cubic": 4, "nearest": 1}[interp]
    assert starts.dtype == np.int32 and weights.dtype == np.float32
    assert (starts >= 0).all() and (starts + k <= n_in).all()
    np.testing.assert_array_equal(
        dense_from_taps(starts, weights, n_in), j_resize_weights(n_in, n_out, interp))


MODES = [vc.INTER_LINEAR, vc.INTER_CUBIC, vc.INTER_NEAREST, vc.INTER_AREA,
         vc.INTER_LANCZOS4]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("out", [(112, 96), (40, 30), (64, 48)])
def test_resize_u8_matches(mode, out):
    """u8 in/out: <= 1 LSB, flips rare (the two packages sum in another
    order, which can move a value across the floor boundary).  Upscaling
    AREA is unquantized bilinear rounded half up, whose dyadic weights put
    many sums exactly on a .5 boundary: there the share is higher."""
    a = np.random.default_rng(7).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    j = np.asarray(vc.resize(a, out, interpolation=mode).data).astype(np.int32)
    t = vt.resize(a, out, interpolation=int(mode)).numpy().astype(np.int32)
    assert t.shape == j.shape == (out[1], out[0], 3)
    d = np.abs(t - j)
    bar = 2e-3 if mode == vc.INTER_AREA else 1e-3
    assert d.max() <= 1 and (d > 0).mean() < bar


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_resize_f32_planar_matches(mode):
    a = np.random.default_rng(8).normal(100, 40, (3, 50, 70)).astype(np.float32)
    j = np.asarray(vc.resize(vc.Image(jnp.asarray(a), vc.CHW), (33, 27),
                             interpolation=mode).data)
    t = vt.resize(vt.Image(torch.from_numpy(a), vt.CHW), (33, 27),
                  interpolation=mode).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-3)


def test_resize_gray_half_and_same_size():
    a = np.random.default_rng(9).integers(0, 256, (30, 40), dtype=np.uint8)
    j = np.asarray(vc.resize(a, (20, 15)).data)
    t = vt.resize(a, (20, 15)).numpy()
    assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
    # same size: the memcpy shortcut returns the input values
    np.testing.assert_array_equal(vt.resize(a, (40, 30)).numpy(), a)
    h = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    out = vt.resize(vt.Image(h), (20, 15))
    assert out.dtype == torch.bfloat16 and out.shape == (15, 20)


def test_resize_fx_fy_and_errors():
    a = np.zeros((10, 20, 3), np.uint8)
    assert vt.resize(a, None, fx=0.5, fy=2.0).shape == (20, 10, 3)
    with pytest.raises(ValueError):
        vt.resize(a, None)
    with pytest.raises(NotImplementedError):
        vt.resize(a, (5, 5), interpolation=vc.INTER_MAX)


def test_device_weights_are_copied_once_and_reused():
    """The chain's resize keeps its weight matrices on the planes' device:
    a second call with the same config reuses the same tensors."""
    planes = torch.rand((3, 41, 57))
    tr._device_weights.cache_clear()
    a = tr.resize_planes(planes, 19, 23, vt.INTER_CUBIC, u8=False)
    first = tr._device_weights(41, 57, 19, 23, int(vt.INTER_CUBIC), False, planes.device)
    b = tr.resize_planes(planes, 19, 23, vt.INTER_CUBIC, u8=False)
    again = tr._device_weights(41, 57, 19, 23, int(vt.INTER_CUBIC), False, planes.device)
    assert first[0] is again[0] and first[1] is again[1]
    info = tr._device_weights.cache_info()
    assert (info.misses, info.hits, info.maxsize) == (1, 3, 256)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    wy, wx = tr._weight_matrices(41, 57, 19, 23, int(vt.INTER_CUBIC), False)
    np.testing.assert_array_equal(first[0].numpy(), wy)
    np.testing.assert_array_equal(first[1].numpy(), wx.T)
