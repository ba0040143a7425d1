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
import re

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
    CardLimits,
    launch_plan,
    one_pass_plan,
    one_pass_stats,
    preprocess_fused_nv_batch,
    preprocess_fused_nv_batch_torch,
)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


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


# ---- the one-pass form: its launch plan and its statistics -----------------

H100 = CardLimits(sms=132, threads_per_sm=2048, smem_bytes=232448 - 128, smem_per_sm=233472)


@pytest.mark.parametrize("n,oh,ow,kw,form,blocks", [
    (32, 224, 224, {}, "one_pass", 16),          # the camera main path: 512 blocks of 256
    (1, 224, 224, {}, "one_pass", 64),           # the tracking frame: a block an SM
    (1, 144, 176, {}, "one_pass", 64),           # config 2's QCIF frame as the output
    (2, 224, 224, {}, "one_pass", 64),
    (3, 224, 224, {}, "one_pass", 32),           # blocks share SMs: 4 pixels a thread or more
    (8, 224, 224, {}, "one_pass", 32),           # 7 rows a block
    (128, 224, 224, {}, "one_pass", 4),
    (1, 37, 99, {}, "one_pass", 32),             # no more blocks than output rows
    (64, 8, 8, {}, "one_pass", 2),               # 128 blocks: no more than the SMs
    (512, 8, 8, {}, "one_pass", 1),              # fewer than 4 pixels a thread at any count
    (512, 224, 224, {}, "two_launch", 0),        # more blocks than the card holds at once
    (32, 1080, 1920, {}, "two_launch", 0),       # strips larger than shared memory
    (32, 224, 224, dict(trunc_u8=False), "two_launch", 0),
    (32, 224, 224, dict(self_stats=False), "resize_only", 0),   # static mean and stddev
    (32, 224, 224, dict(normalize=False), "resize_only", 0),
    (32, 224, 224, dict(form="two_launch"), "two_launch", 0),
])
def test_nv_launch_plan(n, oh, ow, kw, form, blocks):
    plan = launch_plan(n, oh, ow, H100, **kw)
    assert (plan.form, plan.blocks) == (form, blocks)
    if form == "one_pass":
        assert plan == one_pass_plan(n, oh, ow, H100, blocks)
        assert plan.rows == -(-oh // blocks)
        assert plan.chan % 16 == 0 and plan.chan >= plan.rows * ow + 3
        assert 3 * plan.chan <= H100.smem_bytes
        assert 2 * n * blocks * 256 <= H100.sms * H100.threads_per_sm
        assert n * blocks <= H100.sms or plan.rows * ow >= 4 * 256 or oh * ow < 4 * 256
        assert plan.stream == (n * 3 * oh * ow * 4 > 8 << 20)   # evict-first above 8 MB


def test_nv_launch_plan_follows_the_card_and_the_caller():
    small = CardLimits(132, 2048, smem_bytes=10_000, smem_per_sm=233472)
    assert launch_plan(32, 224, 224, small).blocks == 16       # 3 x 3152 bytes
    assert launch_plan(32, 448, 448, small).form == "two_launch"
    few = CardLimits(sms=16, threads_per_sm=2048, smem_bytes=232448 - 128, smem_per_sm=233472)
    assert launch_plan(8, 224, 224, few).blocks == 8           # half of 16 SMs' threads
    assert launch_plan(32, 224, 224, few).form == "two_launch"  # not resident at once
    with pytest.raises(ValueError, match="does not serve"):
        launch_plan(32, 224, 224, H100, trunc_u8=False, form="one_pass")
    with pytest.raises(ValueError, match="self-computed"):
        launch_plan(32, 224, 224, H100, normalize=False, form="two_launch")
    with pytest.raises(ValueError, match="form"):
        launch_plan(32, 224, 224, H100, form="fused")
    with pytest.raises(ValueError, match="form"):
        preprocess_fused_nv_batch(torch.zeros((1, 48, 32), dtype=torch.uint8), None, (8, 8),
                                  form="fused")


@pytest.mark.parametrize("n,oh,ow,blocks,fits", [
    (32, 224, 224, 16, True),
    (32, 224, 224, 32, True),      # 1024 blocks: 8 an SM by threads
    (32, 224, 224, 64, False),     # 2048 blocks: more than the card holds at once
    (1, 224, 224, 1, True),        # one strip of 224 rows: 151 KB of shared memory
    (1, 1080, 1920, 8, False),     # 3 x 259 KB strips: more than shared memory holds
    (1, 8, 8, 16, False),          # more blocks than output rows
])
def test_one_pass_plan_counts_what_the_card_holds(n, oh, ow, blocks, fits):
    plan = one_pass_plan(n, oh, ow, H100, blocks)
    assert (plan is not None) == fits
    if fits:
        per_sm = min(2048 // 256, 32, 233472 // (3 * plan.chan + 128 + 1024))
        assert n * blocks <= 132 * per_sm


def test_plan_constants_are_the_kernels():
    from vacv_tpu_torch.ops.cuda import build
    from vacv_tpu_torch.ops.cuda import preprocess as pk

    # the C interface in preprocess.cu, the kernels and launches in preprocess.cuh
    src = "".join((build.SRC_DIR / f).read_text() for f in ("preprocess.cu", "preprocess.cuh"))
    cases = set(re.findall(r"VACV_ONE_PASS_CASE\((\d), (\d)\)", src))
    assert {(int(a), int(b)) for a, b in cases} == {(1, 1), (1, 2), (2, 1), (2, 2)}
    threads = int(re.search(r"constexpr int kOnePassThreads = (\d+);", src).group(1))
    assert threads == pk._ONE_PASS_THREADS
    assert "as 4 ints at `limits`" in src and len(CardLimits.__dataclass_fields__) == 4
    # The plan counts resident blocks without registers: the kernel's launch
    # bounds hold a thread to the 32 registers of 2048 threads an SM.
    assert "__launch_bounds__(kOnePassThreads, 2048 / kOnePassThreads) nv_one_pass_kernel" in src
    static = re.search(r"part\[6\];.*\n.*total\[6\];.*\n.*stat\[6\];", src)
    assert static and 8 * 6 + 8 * 6 + 4 * 6 <= pk._STATIC_SMEM


@pytest.mark.parametrize("is_nv12", [False, True])
@pytest.mark.parametrize("stats", [(None, None), (MEAN, None), (None, STD)],
                         ids=["self", "static_mean", "static_stddev"])
def test_integer_moment_stats_are_the_plain_versions(is_nv12, stats):
    """The one-pass kernel's μ and σ, from exact integer moments of the
    truncated planes (numpy, int64), agree with the plain version's f32
    two-pass statistics within 1e-6 relative, and the output they give
    with the plain version's and the JAX kernel's."""
    mean, std = stats
    nv = nv_batch(8, n=2)
    raw = port(nv, RECT, OUT, is_nv12=is_nv12, normalize=False)
    assert np.array_equal(raw, np.floor(raw)) and raw.min() >= 0 and raw.max() <= 255
    x = raw.astype(np.int64).reshape(2, 3, -1)
    n = x.shape[-1]
    sx, sxx = x.sum(-1), (x * x).sum(-1)
    mu = sx / n
    sd = np.sqrt((n * sxx - sx * sx).astype(np.float64)) / n
    planes = torch.from_numpy(raw)
    plain_mu = planes.mean(dim=(-2, -1))
    plain_sd = torch.sqrt(torch.square(planes - plain_mu[..., None, None]).mean(dim=(-2, -1)))
    np.testing.assert_allclose(mu, plain_mu.numpy(), rtol=1e-6)
    np.testing.assert_allclose(sd, plain_sd.numpy(), rtol=1e-6)

    k_mu, k_inv = one_pass_stats(planes, mean, std)
    np.testing.assert_allclose(k_mu.numpy(), mu if mean is None else np.broadcast_to(MEAN, mu.shape),
                               rtol=1e-7)
    want_sd = sd if std is None else np.broadcast_to(STD, sd.shape)
    np.testing.assert_allclose(k_inv.numpy(), 1 / (want_sd + 1e-6), rtol=1e-6)
    twin = ((planes - k_mu[..., None, None]) * k_inv[..., None, None]).numpy()
    plain = port(nv, RECT, OUT, is_nv12=is_nv12, mean=mean, stddev=std)
    assert abs(cosine_similarity(twin, plain) - 1) < 1e-6 and np.abs(twin - plain).max() < 1e-4
    jk = np.asarray(j_fused_nv(nv, vc.VRect(*RECT), OUT, is_nv12=is_nv12, mean=mean, stddev=std,
                               precise=True))
    assert_normalized_close(twin, jk)
