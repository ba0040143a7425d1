"""The fused NV preprocess route's plain PyTorch version against vacv_tpu.

``preprocess_fused_nv_batch_torch`` (what the NV CUDA kernel is held to
on the card) gets the same numpy NV buffers as the JAX
``preprocess_fused_nv_batch`` (its Pallas kernel in interpret mode with
``precise=True``) and the JAX decode chain cvt_color → crop → resize →
CHW → f32 → normalize_jnp.  Where the JAX NV plan rejects a crop the
port takes, the decode chain is the only oracle.  The bars are those of
tests/test_preprocess_fused.py: cosine >= 1-1e-6 and max-abs < 0.05 on
normalized output; with ``normalize=False`` at most 1 LSB, on under
1e-3 of the values.
"""
import numpy as np
import pytest
import torch

import vacv_tpu as vc
from vacv_tpu.ops.crop import crop as j_crop
from vacv_tpu.ops.normalize import normalize_jnp
from vacv_tpu.ops.pallas.preprocess import nv_plan_supported
from vacv_tpu.ops.pallas.preprocess import preprocess_fused_nv_batch as j_fused_nv
from vacv_tpu.ops.resize import resize as j_resize
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import VRect
from vacv_tpu_torch.ops.cuda.preprocess import (
    preprocess_fused_nv_batch,
    preprocess_fused_nv_batch_torch,
)

H, W = 360, 640
RECT = (33, 24, 33 + 512, 24 + 224)  # left (odd), top, right, bottom
OUT = (112, 96)  # (w, h)
MEAN = (104.0, 117.0, 123.0)
STD = (57.1, 57.4, 58.4)


def nv_batch(seed, n=1, h=H, w=W):
    """(n, h*3//2, w) stacked NV buffers; any bytes are a valid NV frame."""
    return np.random.default_rng(seed).integers(0, 256, (n, h + (h + 1) // 2, w), dtype=np.uint8)


def code_of(is_nv12, to_rgb):
    return getattr(vc.ColorCode, f"COLOR_YUV2{'RGB' if to_rgb else 'BGR'}_NV{12 if is_nv12 else 21}")


def decode_chain(nv, rect, out, is_nv12=False, to_rgb=False, mean=None, stddev=None,
                 normalize=True):
    """The JAX decode-then-chain: cvt_color → crop → resize → CHW f32 → normalize_jnp."""
    outs = []
    for frame in nv:
        img = vc.cvt_color(frame, code_of(is_nv12, to_rgb))
        if rect is not None:
            img = j_crop(img, vc.VRect(*rect))
        img = j_resize(img, out).change_layout(vc.CHW).change_dtype("float32")
        if normalize:
            img = normalize_jnp(img, mean, stddev)
        outs.append(np.asarray(img.data))
    return np.stack(outs)


def port(nv, rect, out, **kw):
    r = None if rect is None else VRect(*rect)
    return preprocess_fused_nv_batch_torch(torch.from_numpy(nv), r, out, **kw).numpy()


def assert_normalized_close(got, want):
    assert got.shape == want.shape
    assert abs(cosine_similarity(got, want) - 1) < 1e-6
    assert np.max(np.abs(got - want)) < 0.05


def assert_lsb_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1.0 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("is_nv12", [False, True])
@pytest.mark.parametrize("to_rgb", [False, True])
def test_matches_jax_kernel_interpret(is_nv12, to_rgb):
    nv = nv_batch(0, n=2)
    kw = dict(is_nv12=is_nv12, to_rgb=to_rgb)
    want = np.asarray(j_fused_nv(nv, vc.VRect(*RECT), OUT, precise=True, **kw))
    got = port(nv, RECT, OUT, **kw)
    assert got.shape == (2, 3, OUT[1], OUT[0])
    assert_normalized_close(got, want)
    assert_normalized_close(got, decode_chain(nv, RECT, OUT, **kw))


@pytest.mark.parametrize("is_nv12", [False, True])
def test_normalize_false_within_one_lsb(is_nv12):
    nv = nv_batch(1)
    want = np.asarray(j_fused_nv(nv, vc.VRect(*RECT), OUT, is_nv12=is_nv12, normalize=False,
                                 precise=True))
    got = port(nv, RECT, OUT, is_nv12=is_nv12, normalize=False)
    assert_lsb_close(got, want)
    assert_lsb_close(got, decode_chain(nv, RECT, OUT, is_nv12=is_nv12, normalize=False))


@pytest.mark.parametrize("stats", [(MEAN, STD), (MEAN, None), (None, STD), (110.0, 55.0)],
                         ids=["static", "mean_only", "stddev_only", "scalar"])
def test_static_and_partial_stats(stats):
    mean, std = stats
    nv = nv_batch(2)
    assert_normalized_close(port(nv, RECT, OUT, mean=mean, stddev=std),
                            decode_chain(nv, RECT, OUT, mean=mean, stddev=std))
    if stats == (MEAN, None):
        # σ around the self mean, with a static mean: as in the JAX kernel.
        want = np.asarray(j_fused_nv(nv, vc.VRect(*RECT), OUT, mean=MEAN, precise=True))
        assert_normalized_close(port(nv, RECT, OUT, mean=MEAN), want)


@pytest.mark.parametrize("top", [0, 1, 37, 120])
def test_runtime_top(top):
    """A runtime top (int or 0-d tensor), odd ones included: the chroma
    row comes from the absolute Y row.  It equals the static rect it
    describes and the JAX kernel's runtime top."""
    nv = nv_batch(3)
    moved = (RECT[0], top, RECT[2], top + 224)
    static = port(nv, moved, OUT)
    for t in (top, torch.tensor(top), torch.tensor(top, dtype=torch.int32)):
        np.testing.assert_array_equal(port(nv, RECT, OUT, top=t), static)
    assert_normalized_close(static, decode_chain(nv, moved, OUT))
    jk = np.asarray(j_fused_nv(nv, vc.VRect(*RECT), OUT, top=np.int32(top), precise=True))
    assert_normalized_close(static, jk)


@pytest.mark.parametrize("left", [0, 1, 33, 127])
def test_pair_parity_with_odd_left(left):
    """A pixel's chroma pair starts at its absolute column & ~1."""
    nv = nv_batch(4)
    rect = (left, 17, left + 501, 17 + 301)
    assert_lsb_close(port(nv, rect, OUT, is_nv12=True, normalize=False),
                     decode_chain(nv, rect, OUT, is_nv12=True, normalize=False))


def test_runtime_top_is_clamped():
    nv = nv_batch(5)
    bottom = port(nv, RECT, OUT, top=H - 224)
    np.testing.assert_array_equal(port(nv, RECT, OUT, top=10_000), bottom)
    np.testing.assert_array_equal(port(nv, RECT, OUT, top=torch.tensor(10_000)), bottom)
    np.testing.assert_array_equal(port(nv, RECT, OUT, top=-7), port(nv, RECT, OUT, top=0))


@pytest.mark.parametrize("h,w,rect,out", [
    (144, 176, None, (128, 96)),            # akiyo qcif camera frame
    (214, 284, None, (224, 224)),           # Y height not 8-aligned
    (214, 284, (10, 6, 270, 202), (224, 224)),
    (H, W, (0, 0, W, 24), (64, 64)),        # a crop below the JAX chunk floor
    (H, W, (5, 3, 6, 4), (3, 2)),           # a 1x1 crop: one tap each way
])
def test_takes_crops_the_jax_plan_may_reject(h, w, rect, out):
    """The port takes any crop inside the frame; the JAX NV plan rejects
    some (tests/test_preprocess_fused.py:241-247).  Its decode chain is
    the oracle there, and the JAX kernel where the plan takes the crop."""
    nv = nv_batch(6, n=2, h=h, w=w)
    got = port(nv, rect, out)
    assert_normalized_close(got, decode_chain(nv, rect, out))
    assert_lsb_close(port(nv, rect, out, normalize=False),
                     decode_chain(nv, rect, out, normalize=False))
    left, top, cw, ch = (0, 0, w, h) if rect is None else vc.VRect(*rect).int_bounds()
    if nv_plan_supported(h, w, left, cw, ch, out[1], out[0], top):
        want = np.asarray(j_fused_nv(nv, None if rect is None else vc.VRect(*rect), out,
                                     precise=True))
        assert_normalized_close(got, want)


def test_wrapper_on_cpu_runs_plain_version_and_counts_it():
    nv = torch.from_numpy(nv_batch(7, h=64, w=96))
    k0 = config.kernel_count("preprocess_fused_nv")
    p0 = config.kernel_count("preprocess_fused_nv_torch")
    got = preprocess_fused_nv_batch(nv, VRect(5, 3, 91, 61), (32, 24), to_rgb=True)
    want = preprocess_fused_nv_batch_torch(nv, VRect(5, 3, 91, 61), (32, 24), to_rgb=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert config.kernel_count("preprocess_fused_nv") == k0
    assert config.kernel_count("preprocess_fused_nv_torch") == p0 + 1


def test_wrapper_rejects_bad_inputs():
    ok = torch.zeros((1, 48, 32), dtype=torch.uint8)
    for bad in (ok.float(), ok[0], torch.zeros((1, 47, 32), dtype=torch.uint8),
                torch.zeros((1, 48, 31), dtype=torch.uint8)):
        with pytest.raises(ValueError):
            preprocess_fused_nv_batch(bad, None, (8, 8))
    with pytest.raises(ValueError, match="outside the frame"):
        preprocess_fused_nv_batch(ok, VRect(20, 0, 40, 10), (8, 8))  # past the right edge
    with pytest.raises(ValueError, match="outside the frame"):
        preprocess_fused_nv_batch(ok, VRect(0, 0, 32, 33), (8, 8))   # taller than Y
    with pytest.raises(ValueError):
        preprocess_fused_nv_batch(ok, None, (8, 8), top=torch.tensor(1.5))
    with pytest.raises(ValueError):
        preprocess_fused_nv_batch(ok.to("meta"), None, (8, 8))
