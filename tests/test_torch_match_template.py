"""vacv_tpu_torch.match_template / min_max_idx / min_max_loc against
vacv_tpu's on the CPU.

The same seeded numpy images and templates go through the JAX package
(its jnp route, and its Pallas correlation kernel in interpret mode) and
through the port (the correlation kernel's plain version, ``conv2d`` in
f32, on a CPU tensor).  Bars: raw modes within a relative error of 1e-5:
of the response's largest magnitude for CCORR and CCOEFF, and for SQDIFF
(Σw x² − 2·corr + Σ t², a difference of terms several times its size) of
the largest Σw x² + Σ t² it cancels from; NORMED modes within 1e-4
absolute.  The window sums the SQDIFF / NORMED / CCOEFF modes need go
through the window-sum kernel's wrapper; its plain version (the ones-band
products) is held to the JAX package's ``_box_sum`` on its own too.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu import config as jconfig
from vacv_tpu_torch import config
from vacv_tpu.ops.match_template import _box_sum as jax_box_sum
from vacv_tpu_torch.ops.cuda import window_sum as ws
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


@pytest.mark.parametrize("h_out,w_out,c,sms,splits", [
    (673, 1233, 3, 132, 3),   # 720p, 48 x 48: 22 x 10 = 220 tiles, one channel a block
    (673, 1233, 1, 132, 1),   # one channel: nothing to split
    (673, 1233, 5, 132, 3),   # five channels over three blocks: 2, 2, 1
    (329, 609, 3, 132, 3),
    (2000, 4000, 3, 132, 1),  # 63 x 32 = 2016 tiles fill the card
    (673, 1233, 3, 16, 1),    # a small card: the tiles fill it
])
def test_corr_split_plan(h_out, w_out, c, sms, splits):
    """How many blocks share a tile's channels (csrc/match_template.cu):
    one while the tiles give every SM four blocks, else up to one channel
    a block, with no split left empty."""
    from vacv_tpu_torch.ops.cuda import match_template as mt

    got = mt.split_plan(h_out, w_out, c, sms)
    assert got == splits
    per = -(-c // got)
    assert (got - 1) * per < c


# ---- the window sums: Σ_c x² and the per-channel sums over each window ----

def window_image(kind, c, h, w, seed):
    """(c, h, w) f32: u8 values, random f32, one flat value, or u8 values
    of low variance (100 or 101)."""
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return rng.integers(0, 256, (c, h, w)).astype(np.float32)
    if kind == "f32":
        return rng.random((c, h, w), dtype=np.float32) * 2 - 1
    if kind == "flat":
        return np.full((c, h, w), 50.0, np.float32)
    return (100 + rng.integers(0, 2, (c, h, w))).astype(np.float32)


def window_cases():
    """(h, w, th, tw): sizes 1x1 to 96x128, templates 1x1, 1xW, Hx1, 5x6
    and 48x48 where they fit."""
    cases = []
    for h, w in ((1, 1), (7, 5), (37, 61), (96, 128)):
        for th, tw in ((1, 1), (1, w), (h, 1), (5, 6), (48, 48)):
            if th <= h and tw <= w and (h, w, th, tw) not in cases:
                cases.append((h, w, th, tw))
    return cases


@pytest.mark.parametrize("kind", ["u8", "f32", "flat", "low variance"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h,w,th,tw", window_cases())
def test_window_sums_match_jax_box_sum(h, w, th, tw, channels, kind):
    """The plain version's Σ_c x² and per-channel window sums against the
    JAX package's ``_box_sum`` (ones-band products at HIGHEST precision):
    within 1e-5 of the largest sum, the per-channel sums of integer images
    equal (every partial sum an integer below 2^24); the same from an HWC
    image's strided planes."""
    x = window_image(kind, channels, h, w, seed=h * w + th + tw + channels)
    want_sq = np.asarray(jax_box_sum(jnp.sum(jnp.asarray(x) ** 2, axis=0), th, tw))
    want_sums = np.asarray(jax_box_sum(jnp.asarray(x), th, tw))
    hwc = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 2, 0))).permute(2, 0, 1)
    for planes in (torch.from_numpy(x), hwc):
        sq, sums = ws.window_sums(planes, th, tw, sq=True, sums=True)
        for got, want in ((sq.numpy(), want_sq), (sums.numpy(), want_sums)):
            assert got.shape == want.shape and got.dtype == np.float32
            assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-30)
        if kind != "f32":
            np.testing.assert_array_equal(sums.numpy(), want_sums)


# The card's shapes of the window-sum kernel (chip_smoke.py's compare phase
# and the card tests): the tracking frame, a window wider than one pass of
# 128 threads, full-width and full-height windows, 2 and 5 channels.
CARD_WINDOWS = [(3, 720, 1280, 48, 48), (3, 97, 161, 65, 33), (2, 120, 300, 7, 129),
                (1, 40, 300, 40, 300), (3, 37, 61, 1, 61), (5, 64, 70, 64, 1), (1, 1, 1, 1, 1)]


@pytest.mark.parametrize("sq,sums", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("c,h,w,th,tw", [(c, *case) for case in window_cases() for c in (1, 3)]
                         + CARD_WINDOWS)
def test_window_sum_launch_plan(c, h, w, th, tw, sq, sums):
    """The kernel's launch on the host: the strips cover the output, a
    block's threads walk every column of a pass, the ring and stages fit the
    card's shared memory, and the passes cover the window and channels."""
    plan = ws.launch_plan(c, h, w, th, tw, sq=sq, sums=sums)
    ho, wo = h - th + 1, w - tw + 1
    assert plan.threads in (128, 256) and ws.TILE_X + plan.kc - 1 <= plan.threads
    assert 1 <= plan.kr <= th and 1 <= plan.kc <= tw and plan.cn == min(c, 4)
    nq = int(sq) + (plan.cn if sums else 0)
    assert plan.smem == ws.window_smem(nq, plan.kr, plan.kc) <= ws.SMEM_BLOCK
    assert plan.per_sm >= 1 and plan.per_sm * (plan.smem + 1024) <= ws.SMEM_SM
    assert plan.rows % ws.BATCH == 0 and plan.rows >= ws.BATCH
    assert (plan.row_tiles - 1) * plan.rows < ho <= plan.row_tiles * plan.rows <= 65535 * plan.rows
    assert (plan.col_tiles - 1) * ws.TILE_X < wo <= plan.col_tiles * ws.TILE_X
    assert plan.passes == -(-c // plan.cn) * -(-th // plan.kr) * -(-tw // plan.kc)
    # The same strips and passes whatever is asked for: the same bits of each sum.
    both = ws.launch_plan(c, h, w, th, tw, sq=True, sums=True)
    assert (plan.rows, plan.kr, plan.kc, plan.threads) == (both.rows, both.kr, both.kc,
                                                           both.threads)
    if (c, h, w, th, tw) == CARD_WINDOWS[0]:
        # The tracking frame: one pass, and a block on every SM at once.
        assert plan.passes == 1 and plan.col_tiles * plan.row_tiles >= 132
    assert ws.launch_plan(c, h, w, th, tw, sq=sq, sums=sums, rows=13).rows == 16


def test_window_sum_plan_constants_are_the_kernels():
    """The plan's constants and its shared-memory formula are the kernel's."""
    import re

    src = (ws.build.SRC_DIR / "window_sum.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kTileX"]), int(consts["kBatch"])) == (ws.TILE_X, ws.BATCH)
    assert "return (ncol + 6) / 8 * 8 + 1;" in src
    assert ("return 4 * (kr * ncol * e + kBatch * stage_pitch(ncol) * e + "
            "kBatch * nq * (kTileX + 1));") in src
    assert ws.window_smem(4, 48, 48) == 4 * (48 * 111 * 4 + 8 * 113 * 4 + 8 * 4 * 65)

@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_modes_match_jax_at_the_tracking_template(mode):
    """The tracking flow's 48x48 template over a 96x128 u8 image."""
    img, tmpl = scene(13, 3, np.uint8, h=96, w=128, th=48, tw=48)
    with jconfig.backend("jnp"):
        want = np.asarray(vc.match_template(img, tmpl, int(mode)).data)
    got = vt.match_template(img, tmpl, mode).numpy()
    assert got.shape == (49, 81)
    assert_response_close(got, want, mode, img, tmpl)


def test_window_sums_take_one_call_a_match():
    """One window-sum call a match where a mode needs window sums (both
    sums in one call for TM_CCOEFF_NORMED), none for CCORR and CCOEFF; the
    plain version here (no card), and uncounted under the torch backend.
    The ones-band products live only in that plain version now."""
    img, tmpl = scene(14, 3, np.uint8)
    calls = {vt.TM_SQDIFF: 1, vt.TM_SQDIFF_NORMED: 1, vt.TM_CCORR: 0, vt.TM_CCORR_NORMED: 1,
             vt.TM_CCOEFF: 0, vt.TM_CCOEFF_NORMED: 1}
    for mode, n in calls.items():
        k0, p0 = config.kernel_count("window_sum"), config.kernel_count("window_sum_torch")
        vt.match_template(img, tmpl, mode)
        assert config.kernel_count("window_sum_torch") == p0 + n, mode.name
        assert config.kernel_count("window_sum") == k0  # no card here
    with config.backend("torch"):
        p0 = config.kernel_count("window_sum_torch")
        vt.match_template(img, tmpl, vt.TM_CCOEFF_NORMED)
        assert config.kernel_count("window_sum_torch") == p0
    mt = importlib.import_module("vacv_tpu_torch.ops.match_template")
    assert not hasattr(mt, "_ones_band") and not hasattr(mt, "_box_sum")


def test_window_sum_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((3, 16, 20))
    with pytest.raises(ValueError, match="float32"):
        ws.window_sums(x[0], 4, 4)
    with pytest.raises(ValueError, match="float32"):
        ws.window_sums(x.double(), 4, 4)
    with pytest.raises(ValueError, match="does not fit"):
        ws.window_sums(x, 17, 4)
    with pytest.raises(ValueError, match="does not fit"):
        ws.window_sums(x, 4, 0)
    with pytest.raises(ValueError, match="ask for"):
        ws.window_sums(x, 4, 4, sq=False, sums=False)
    sq, sums = ws.window_sums(x + 1, 4, 5, sq=False, sums=True)
    assert sq is None and sums.shape == (3, 13, 16) and bool((sums == 20).all())

