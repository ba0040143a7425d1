"""The fused preprocess route's plain PyTorch version against vacv_tpu.

``preprocess_fused_batch_torch`` (what the CUDA kernel is held to on the
card) gets the same numpy batches as the JAX ``preprocess_fused_batch``
(its Pallas kernel in interpret mode with ``precise=True``, exact to f32
accumulation) and the jnp chain crop → resize → CHW → f32 →
normalize_jnp.  The bars are those of tests/test_preprocess_fused.py:
cosine >= 1-1e-6 and max-abs < 0.05 on normalized output; with
``normalize=False`` at most 1 LSB, on under 1e-3 of the values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vacv_tpu as vc
from vacv_tpu.ops.crop import crop as j_crop
from vacv_tpu.ops.normalize import normalize_jnp
from vacv_tpu.ops.pallas.preprocess import preprocess_fused_batch as j_fused
from vacv_tpu.ops.resize import resize as j_resize
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import VRect
from vacv_tpu_torch.ops.cuda.preprocess import (
    preprocess_fused_batch,
    preprocess_fused_batch_torch,
)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


H, W = 360, 640
RECT = (17, 20, 17 + 600, 20 + 320)  # left, top, right, bottom
OUT = (112, 96)  # (w, h)
MEAN = (104.0, 117.0, 123.0)
STD = (57.1, 57.4, 58.4)
INTER = {"linear": vc.INTER_LINEAR, "cubic": vc.INTER_CUBIC, "nearest": vc.INTER_NEAREST}


def make_batch(seed, n=2, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def jnp_chain(batch, rect, out, mean=None, stddev=None, normalize=True, interp="linear"):
    outs = []
    for frame in batch:
        img = vc.Image(jnp.asarray(frame), vc.HWC)
        if rect is not None:
            img = j_crop(img, vc.VRect(*rect))
        img = j_resize(img, out, interpolation=INTER[interp])
        img = img.change_layout(vc.CHW).change_dtype("float32")
        if normalize:
            img = normalize_jnp(img, mean, stddev)
        outs.append(np.asarray(img.data))
    return np.stack(outs)


def port(batch, rect, out, **kw):
    r = None if rect is None else VRect(*rect)
    return preprocess_fused_batch_torch(torch.from_numpy(batch), r, out, **kw).numpy()


def assert_normalized_close(got, want):
    assert got.shape == want.shape
    assert abs(cosine_similarity(got, want) - 1) < 1e-6
    assert np.max(np.abs(got - want)) < 0.05


def assert_lsb_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1.0 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("interp", ["linear", "cubic", "nearest"])
@pytest.mark.parametrize("normalize", [True, False])
def test_matches_jax_kernel_interpret(interp, normalize):
    batch = make_batch(0)
    want = np.asarray(j_fused(batch, vc.VRect(*RECT), OUT, precise=True,
                              interp=interp, normalize=normalize))
    got = port(batch, RECT, OUT, interp=interp, normalize=normalize)
    assert got.shape == (2, 3, OUT[1], OUT[0])
    (assert_normalized_close if normalize else assert_lsb_close)(got, want)


@pytest.mark.parametrize("interp", ["linear", "cubic", "nearest"])
def test_matches_jnp_chain(interp):
    batch = make_batch(1)
    assert_normalized_close(port(batch, RECT, OUT, interp=interp),
                            jnp_chain(batch, RECT, OUT, interp=interp))
    assert_lsb_close(port(batch, RECT, OUT, interp=interp, normalize=False),
                     jnp_chain(batch, RECT, OUT, interp=interp, normalize=False))


@pytest.mark.parametrize("stats", [(MEAN, STD), (MEAN, None), (None, STD), (110.0, 55.0)],
                         ids=["static", "mean_only", "stddev_only", "scalar"])
def test_static_and_partial_stats(stats):
    mean, std = stats
    batch = make_batch(2, n=1)
    assert_normalized_close(port(batch, RECT, OUT, mean=mean, stddev=std),
                            jnp_chain(batch, RECT, OUT, mean=mean, stddev=std))


def test_partial_stats_match_jax_kernel():
    """mean given, σ self-computed around the self mean (in-kernel in
    the reference too)."""
    batch = make_batch(3, n=1)
    want = np.asarray(j_fused(batch, vc.VRect(*RECT), OUT, mean=MEAN, precise=True))
    assert_normalized_close(port(batch, RECT, OUT, mean=MEAN), want)


def test_runtime_top():
    """A runtime top (int or 0-d tensor) equals the static rect it
    describes, and matches the JAX kernel's runtime top."""
    batch = make_batch(4, n=1)
    static = port(batch, RECT, OUT)
    for top in (RECT[1], torch.tensor(RECT[1], dtype=torch.int32)):
        np.testing.assert_array_equal(port(batch, RECT, OUT, top=top), static)
    top2 = 13
    moved = (RECT[0], top2, RECT[2], top2 + 320)
    want = jnp_chain(batch, moved, OUT)
    for top in (top2, torch.tensor(top2), torch.tensor(top2, dtype=torch.int32)):
        assert_normalized_close(port(batch, RECT, OUT, top=top), want)
    jk = np.asarray(j_fused(batch, vc.VRect(*RECT), OUT, top=np.int32(top2), precise=True))
    assert_normalized_close(port(batch, RECT, OUT, top=top2), jk)


def test_runtime_top_is_clamped():
    """A top past H - ch (or below 0) is clamped, as the kernel clamps it."""
    batch = make_batch(5, n=1)
    ch = RECT[3] - RECT[1]
    bottom = port(batch, RECT, OUT, top=H - ch)
    np.testing.assert_array_equal(port(batch, RECT, OUT, top=10_000), bottom)
    np.testing.assert_array_equal(port(batch, RECT, OUT, top=torch.tensor(10_000)), bottom)
    np.testing.assert_array_equal(port(batch, RECT, OUT, top=-7), port(batch, RECT, OUT, top=0))


@pytest.mark.parametrize("h,w,rect", [
    (144, 176, None), (214, 284, None), (214, 284, (10, 6, 270, 202)),
])
def test_odd_geometry_assets(h, w, rect):
    """The reference's own odd-geometry assets (176x144, 284x214): the
    port needs no padding for them."""
    batch = make_batch(6, h=h, w=w)
    assert_normalized_close(port(batch, rect, (224, 224)), jnp_chain(batch, rect, (224, 224)))


def test_full_frame_and_odd_output():
    batch = make_batch(7, h=96, w=128)
    assert_normalized_close(port(batch, None, (100, 60)), jnp_chain(batch, None, (100, 60)))
    assert_lsb_close(port(batch, None, (100, 60), normalize=False),
                     jnp_chain(batch, None, (100, 60), normalize=False))


def test_wrapper_on_cpu_runs_plain_version_and_counts_it():
    batch = torch.from_numpy(make_batch(8, n=1, h=64, w=96))
    k0 = config.kernel_count("preprocess_fused")
    p0 = config.kernel_count("preprocess_fused_torch")
    got = preprocess_fused_batch(batch, VRect(4, 2, 90, 60), (32, 24))
    want = preprocess_fused_batch_torch(batch, VRect(4, 2, 90, 60), (32, 24))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert config.kernel_count("preprocess_fused") == k0
    assert config.kernel_count("preprocess_fused_torch") == p0 + 1


def test_wrapper_rejects_bad_inputs():
    ok = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        preprocess_fused_batch(ok.float(), None, (8, 8))
    with pytest.raises(ValueError):
        preprocess_fused_batch(ok[0], None, (8, 8))
    with pytest.raises(ValueError):
        preprocess_fused_batch(torch.zeros((1, 32, 32, 4), dtype=torch.uint8), None, (8, 8))
    with pytest.raises(ValueError):
        preprocess_fused_batch(ok, VRect(20, 0, 40, 10), (8, 8))  # past the right edge
    with pytest.raises(ValueError):
        preprocess_fused_batch(ok, None, (8, 8), interp="area")
    with pytest.raises(ValueError):
        preprocess_fused_batch(ok.to("meta"), None, (8, 8))
