"""vacv_tpu_torch.match_template / min_max_idx / min_max_loc against
vacv_tpu's on the CPU.

The same seeded numpy images and templates go through the JAX package
(its jnp route, and its Pallas correlation kernel in interpret mode) and
through the port (the correlation kernel's plain version, ``conv2d`` in
f32, on a CPU tensor).  Bars: raw modes within a relative error of 1e-5:
of the response's largest magnitude for CCORR and CCOEFF, and for SQDIFF
(Σw x² − 2·corr + Σ t², a difference of terms several times its size) of
the largest Σw x² + Σ t² it cancels from; NORMED modes within 1e-4
absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu import config as jconfig
from vacv_tpu_torch import config
from vacv_tpu_torch.ops.cuda.match_template import corr_planes, corr_planes_torch


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


MODES = [vt.TM_SQDIFF, vt.TM_SQDIFF_NORMED, vt.TM_CCORR, vt.TM_CCORR_NORMED, vt.TM_CCOEFF,
         vt.TM_CCOEFF_NORMED]
NORMED = {vt.TM_SQDIFF_NORMED, vt.TM_CCORR_NORMED, vt.TM_CCOEFF_NORMED}


def scene(seed, channels, dtype, h=48, w=64, th=12, tw=9):
    """A noise image and a template cut from it (a perfect match at
    (x, y) = (20, 17))."""
    img = np.random.default_rng(seed).integers(0, 256, (h, w, channels), dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    img = img.astype(dtype)
    if dtype == np.float32:
        img = img + np.float32(0.25)
    return img, np.ascontiguousarray(img[17:17 + th, 20:20 + tw])


def assert_response_close(got, want, mode, img=None, tmpl=None):
    assert got.shape == want.shape and got.dtype == np.float32
    if mode in NORMED:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        return
    scale = np.abs(want).max()
    if mode == vt.TM_SQDIFF:
        th, tw = tmpl.shape[:2]
        sq = (img.astype(np.float64) ** 2).reshape(img.shape[0], img.shape[1], -1).sum(-1)
        win = np.lib.stride_tricks.sliding_window_view(sq, (th, tw)).sum(axis=(-2, -1))
        scale = win.max() + (tmpl.astype(np.float64) ** 2).sum()
    assert np.abs(got - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_modes_match_jax(mode, channels, dtype):
    img, tmpl = scene(channels, channels, dtype)
    with jconfig.backend("jnp"):
        want = np.asarray(vc.match_template(img, tmpl, int(mode)).data)
    got = vt.match_template(img, tmpl, mode)
    assert got.data.shape == (48 - 12 + 1, 64 - 9 + 1)
    assert_response_close(got.numpy(), want, mode, img, tmpl)


@pytest.mark.parametrize("mode", [vt.TM_CCORR, vt.TM_CCOEFF_NORMED], ids=lambda m: m.name)
def test_modes_match_the_pallas_kernel(mode):
    """The JAX correlation kernel in interpret mode against the port."""
    img, tmpl = scene(7, 3, np.uint8)
    before = jconfig.kernel_count("match_corr")
    with jconfig.backend("pallas"):
        want = np.asarray(vc.match_template(img, tmpl, int(mode)).data)
    assert jconfig.kernel_count("match_corr") == before + 1
    assert_response_close(vt.match_template(img, tmpl, mode).numpy(), want, mode)


def test_corr_matches_jax_for_a_wide_template_and_strided_image():
    """A 7×129 template (wider than the TPU kernel's gate) over an HWC
    image read through its strides."""
    rng = np.random.default_rng(8)
    x = rng.random((3, 30, 160), dtype=np.float32) * 2 - 1
    k = rng.random((3, 7, 129), dtype=np.float32) * 2 - 1
    from vacv_tpu.ops.match_template import _corr

    with jconfig.backend("jnp"):
        want = np.asarray(_corr(jnp.asarray(x[None]), jnp.asarray(k[None])))
    hwc = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 2, 0)))
    k0, p0 = config.kernel_count("match_corr"), config.kernel_count("match_corr_torch")
    got = corr_planes(hwc.permute(2, 0, 1), torch.from_numpy(k)).numpy()
    assert config.kernel_count("match_corr_torch") == p0 + 1
    assert config.kernel_count("match_corr") == k0  # no card here
    assert got.shape == (24, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_flat_window_hits_the_normed_clamp():
    """A flat window (zero variance) gives the 1.125·den clamp's 0 for
    CCOEFF_NORMED, as in the JAX package."""
    img = np.full((20, 24), 50.0, np.float32)
    img[10:, 12:] = np.random.default_rng(9).integers(0, 256, (10, 12)).astype(np.float32)
    tmpl = np.random.default_rng(10).integers(0, 256, (5, 6)).astype(np.float32)
    for mode in (vt.TM_CCOEFF_NORMED, vt.TM_SQDIFF_NORMED, vt.TM_CCORR_NORMED):
        with jconfig.backend("jnp"):
            want = np.asarray(vc.match_template(img, tmpl, int(mode)).data)
        got = vt.match_template(img, tmpl, mode).numpy()
        assert_response_close(got, want, mode)
    got = vt.match_template(img, tmpl, vt.TM_CCOEFF_NORMED).numpy()
    assert (got[:5, :6] == 0).all()  # flat windows


def test_min_max_idx_ties_mask_and_all_masked():
    x = np.array([[3.0, 1.0, 7.0], [7.0, -2.0, -2.0]], np.float32)
    for args in ((x,), (x, np.array([[1, 1, 0], [1, 0, 0]], np.uint8))):
        want = [np.asarray(v) for v in vc.min_max_idx(*args)]
        got = [v.numpy() for v in vt.min_max_idx(*[torch.from_numpy(a) for a in args])]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    mn, mx, mi, ma = vt.min_max_idx(torch.from_numpy(x))
    assert (float(mn), float(mx), int(mi), int(ma)) == (-2.0, 7.0, 4, 2)  # first on ties
    mn, mx, _, _ = vt.min_max_idx(x, np.zeros_like(x, dtype=np.uint8))
    assert np.isnan(float(mn)) and np.isnan(float(mx))


def test_min_max_loc_finds_the_match_and_stays_a_tensor():
    img, tmpl = scene(11, 3, np.uint8)
    resp = vt.match_template(img, tmpl, vt.TM_CCOEFF_NORMED)
    mn, mx, (min_x, min_y), (max_x, max_y) = vt.min_max_loc(resp)
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0
               for v in (mn, mx, min_x, min_y, max_x, max_y))
    assert (int(max_x), int(max_y)) == (20, 17) and float(mx) > 0.999
    want = vc.min_max_loc(np.asarray(resp.numpy()))
    assert (int(want[3][0]), int(want[3][1])) == (20, 17)
    assert (int(min_x), int(min_y)) == (int(want[2][0]), int(want[2][1]))


def test_corr_wrapper_rejects_what_the_kernel_does_not_take():
    img = torch.zeros((3, 16, 16))
    with pytest.raises(ValueError, match="C, H, W"):
        corr_planes(img[0], torch.zeros((3, 4, 4)))
    with pytest.raises(ValueError, match="float32"):
        corr_planes(img.double(), torch.zeros((3, 4, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="does not fit"):
        corr_planes(img, torch.zeros((3, 17, 4)))
    with pytest.raises(ValueError, match="does not fit"):
        corr_planes(img, torch.zeros((1, 4, 4)))
    np.testing.assert_array_equal(corr_planes(img, torch.ones((3, 4, 4))).numpy(),
                                  corr_planes_torch(img, torch.ones((3, 4, 4))).numpy())
