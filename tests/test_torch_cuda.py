"""The CUDA kernels on the card: ``pytest -m gpu tests/test_torch_cuda.py``.

Each test takes the ``cuda`` fixture, which skips when PyTorch sees no
CUDA device, so on a CPU-only host the whole file skips.  Each kernel is
held to its plain PyTorch version on the same CUDA tensors: the fused
preprocess kernels to cosine >= 1-1e-6 and max-abs < 0.05 normalized,
and at most 1 LSB on under 1e-3 of the values with ``normalize=False``;
yuv2bgr bit-exact; normalize to cosine >= 1-1e-6 and max-abs < 1e-4.
"""
import pytest
import torch

import vacv_tpu_torch as vt
from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import ColorCode, InterMode, VRect
from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
from vacv_tpu_torch.ops.cuda.normalize import normalize_fused
from vacv_tpu_torch.ops.cuda.preprocess import (
    preprocess_fused_batch,
    preprocess_fused_batch_torch,
    preprocess_fused_nv_batch,
    preprocess_fused_nv_batch_torch,
)
from vacv_tpu_torch.ops.cuda.yuv2bgr import nv_to_bgr
from vacv_tpu_torch.ops.cvt_color import nv_to_bgr_planes_torch
from vacv_tpu_torch.ops.normalize import normalize_torch
from vacv_tpu_torch.utils.compare import cosine_similarity

pytestmark = pytest.mark.gpu

RECT = VRect(17, 20, 617, 340)
OUT = (112, 96)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def batch_on(device, n=4, h=360, w=640, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=g, dtype=torch.uint8,
                         device=device)


def cosine(a, b):
    return cosine_similarity(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("interp", ["linear", "cubic", "nearest"])
@pytest.mark.parametrize("stats", ["self", "static", "mean_only", "raw"])
def test_kernel_matches_plain_version(cuda, interp, stats):
    kw = {
        "self": {},
        "static": dict(mean=(104.0, 117.0, 123.0), stddev=(57.1, 57.4, 58.4)),
        "mean_only": dict(mean=(104.0, 117.0, 123.0)),
        "raw": dict(normalize=False),
    }[stats]
    batch = batch_on(cuda)
    got = preprocess_fused_batch(batch, RECT, OUT, interp=interp, **kw)
    torch.cuda.synchronize()
    want = preprocess_fused_batch_torch(batch, RECT, OUT, interp=interp, **kw)
    assert got.device == cuda and got.shape == want.shape == (4, 3, OUT[1], OUT[0])
    d = (got - want).abs()
    if stats == "raw":
        assert d.max().item() <= 1.0 and (d > 0).double().mean().item() < 1e-3
    else:
        assert cosine(got, want) >= 1 - 1e-6 and d.max().item() < 0.05


def test_runtime_top_device_tensor_and_clamp(cuda):
    batch = batch_on(cuda, seed=1)
    a = preprocess_fused_batch(batch, RECT, OUT, top=9)
    b = preprocess_fused_batch(batch, RECT, OUT,
                               top=torch.tensor(9, dtype=torch.int32, device=cuda))
    far = preprocess_fused_batch(batch, RECT, OUT, top=torch.tensor(10_000, device=cuda))
    bottom = preprocess_fused_batch(batch, RECT, OUT, top=360 - 320)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(far, bottom)


def test_launch_counter_rises_once_per_call(cuda):
    batch = batch_on(cuda, n=2, seed=2)
    k0 = config.kernel_count("preprocess_fused")
    p0 = config.kernel_count("preprocess_fused_torch")
    preprocess_fused_batch(batch, RECT, OUT)                       # two launches
    preprocess_fused_batch(batch, RECT, OUT, normalize=False)      # one launch
    torch.cuda.synchronize()
    assert config.kernel_count("preprocess_fused") == k0 + 2
    assert config.kernel_count("preprocess_fused_torch") == p0


def test_cpu_tensor_never_counts_a_launch(cuda):
    batch = batch_on(cuda, n=1, seed=3).cpu()
    k0 = config.kernel_count("preprocess_fused")
    preprocess_fused_batch(batch, RECT, OUT)
    assert config.kernel_count("preprocess_fused") == k0


def test_wrapper_raises_on_inputs_the_kernel_does_not_take(cuda):
    batch = batch_on(cuda, n=2, seed=4)
    k0 = config.kernel_count("preprocess_fused")
    with pytest.raises(ValueError, match="contiguous"):
        preprocess_fused_batch(batch[:, :, ::2], VRect(0, 0, 300, 300), OUT)
    with pytest.raises(ValueError, match="uint8"):
        preprocess_fused_batch(batch.float(), RECT, OUT)
    with pytest.raises(ValueError):
        preprocess_fused_batch(batch, RECT, OUT, top=torch.tensor(1.5, device=cuda))
    assert config.kernel_count("preprocess_fused") == k0


# ---- the NV camera path ---------------------------------------------------

NV_RECT = VRect(33, 24, 33 + 512, 24 + 224)  # odd left


def nv_on(device, n=2, h=360, w=640, seed=0):
    """(n, h + ceil(h/2), w) stacked NV buffers; any bytes are valid."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n, h + (h + 1) // 2, w), generator=g,
                         dtype=torch.uint8, device=device)


def assert_close(got, want, stats):
    assert got.shape == want.shape
    d = (got - want).abs()
    if stats == "raw":
        assert d.max().item() <= 1.0 and (d > 0).double().mean().item() < 1e-3
    else:
        assert cosine(got, want) >= 1 - 1e-6 and d.max().item() < 0.05


@pytest.mark.parametrize("is_nv12", [False, True])
@pytest.mark.parametrize("to_rgb", [False, True])
@pytest.mark.parametrize("stats", ["self", "static", "mean_only", "raw"])
def test_nv_kernel_matches_plain_version(cuda, is_nv12, to_rgb, stats):
    kw = {
        "self": {},
        "static": dict(mean=(104.0, 117.0, 123.0), stddev=(57.1, 57.4, 58.4)),
        "mean_only": dict(mean=(104.0, 117.0, 123.0)),
        "raw": dict(normalize=False),
    }[stats]
    nv = nv_on(cuda)
    got = preprocess_fused_nv_batch(nv, NV_RECT, OUT, is_nv12=is_nv12, to_rgb=to_rgb, **kw)
    torch.cuda.synchronize()
    want = preprocess_fused_nv_batch_torch(nv, NV_RECT, OUT, is_nv12=is_nv12, to_rgb=to_rgb, **kw)
    assert got.device == cuda and got.shape == (2, 3, OUT[1], OUT[0])
    assert_close(got, want, stats)


@pytest.mark.parametrize("top", [0, 1, 37, 120])
def test_nv_runtime_top_on_device_and_clamp(cuda, top):
    nv = nv_on(cuda, seed=1)
    a = preprocess_fused_nv_batch(nv, NV_RECT, OUT, top=top)
    b = preprocess_fused_nv_batch(nv, NV_RECT, OUT,
                                  top=torch.tensor(top, dtype=torch.int32, device=cuda))
    want = preprocess_fused_nv_batch_torch(nv, NV_RECT, OUT, top=top)
    far = preprocess_fused_nv_batch(nv, NV_RECT, OUT, top=torch.tensor(10_000, device=cuda))
    bottom = preprocess_fused_nv_batch(nv, NV_RECT, OUT, top=360 - 224)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(far, bottom)
    assert_close(a, want, "self")


@pytest.mark.parametrize("h,w", [(144, 176), (214, 284), (2, 2)])
def test_nv_kernel_odd_frames(cuda, h, w):
    nv = nv_on(cuda, h=h, w=w, seed=2)
    for kw, stats in (({}, "self"), (dict(normalize=False), "raw")):
        got = preprocess_fused_nv_batch(nv, None, (224, 224), **kw)
        assert_close(got, preprocess_fused_nv_batch_torch(nv, None, (224, 224), **kw), stats)


@pytest.mark.parametrize("is_nv12", [False, True])
@pytest.mark.parametrize("h,w", [(1080, 1920), (1079, 1920), (215, 284), (1, 2)])
def test_yuv2bgr_kernel_is_bit_exact(cuda, is_nv12, h, w):
    buf = nv_on(cuda, n=1, h=h, w=w, seed=3)[0]
    y, vu = buf[:h], buf[h:]
    got = nv_to_bgr(y, vu, is_nv12=is_nv12)
    want = nv_to_bgr_planes_torch(y, vu, is_nv12=is_nv12)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.device == cuda and torch.equal(a, b)


@pytest.mark.parametrize("shape", [(3, 1080, 1920), (3, 224, 224), (5, 37, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_normalize_kernel_matches_plain_version(cuda, shape, dtype):
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    x = torch.randint(0, 256, shape, generator=g, device=cuda).to(dtype)
    got = normalize_fused(x)
    want = normalize_torch(vt.Image(x, vt.CHW)).data
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == shape
    assert cosine(got, want) >= 1 - 1e-6 and (got - want).abs().max().item() < 1e-4


def test_new_launch_counters_rise_once_per_call(cuda):
    nv = nv_on(cuda, seed=5)
    names = ("preprocess_fused_nv", "yuv2bgr", "normalize_fused",
             "preprocess_fused_nv_torch", "yuv2bgr_torch", "normalize_fused_torch")
    before = {k: config.kernel_count(k) for k in names}
    preprocess_fused_nv_batch(nv, NV_RECT, OUT)                  # two launches, one call
    preprocess_fused_nv_batch(nv, NV_RECT, OUT, normalize=False)
    vt.cvt_color(nv[0], ColorCode.COLOR_YUV2BGR_NV21)
    normalize_fused(torch.rand((3, 64, 80), device=cuda))
    torch.cuda.synchronize()
    rose = {k: config.kernel_count(k) - before[k] for k in names}
    assert rose == {"preprocess_fused_nv": 2, "yuv2bgr": 1, "normalize_fused": 1,
                    "preprocess_fused_nv_torch": 0, "yuv2bgr_torch": 0,
                    "normalize_fused_torch": 0}


def test_preprocessor_nv_routes_launch_their_kernels(cuda):
    """The fused NV route launches its kernel once per batch; the cubic
    NV chain launches yuv2bgr and normalize once per frame.  Neither
    falls back to a plain version."""
    nv = nv_on(cuda, n=3, seed=6)
    cfg = PreprocessConfig(color_code=ColorCode.COLOR_YUV2BGR_NV21, crop_rect=NV_RECT,
                           out_size=OUT)
    cubic = PreprocessConfig(color_code=ColorCode.COLOR_YUV2BGR_NV21, crop_rect=NV_RECT,
                             out_size=OUT, interpolation=InterMode.INTER_CUBIC)
    names = ("preprocess_fused_nv", "yuv2bgr", "normalize_fused")
    for c, route, rose in ((cfg, "cuda_fused_nv", (1, 0, 0)), (cubic, "torch_chain", (0, 3, 3))):
        pre = Preprocessor(c, device="cuda")
        assert pre.describe_route(nv.shape[1:]) == route
        before = [config.kernel_count(k) for k in names]
        got = pre.batch(nv, top=torch.tensor(30, device=cuda))
        torch.cuda.synchronize()
        assert tuple(config.kernel_count(k) - b for k, b in zip(names, before)) == rose
        with config.backend("torch"):
            want = pre.batch(nv, top=torch.tensor(30, device=cuda))
        assert_close(got, want, "self")


def test_new_cpu_tensors_never_count_a_launch(cuda):
    nv = nv_on(cuda, n=1, seed=7).cpu()
    names = ("preprocess_fused_nv", "yuv2bgr", "normalize_fused")
    before = [config.kernel_count(k) for k in names]
    preprocess_fused_nv_batch(nv, NV_RECT, OUT)
    nv_to_bgr(nv[0, :360], nv[0, 360:], is_nv12=False)
    normalize_fused(torch.rand((3, 8, 8)))
    assert [config.kernel_count(k) for k in names] == before


def test_new_wrappers_raise_on_inputs_their_kernels_do_not_take(cuda):
    nv = nv_on(cuda, seed=8)
    names = ("preprocess_fused_nv", "yuv2bgr", "normalize_fused")
    before = [config.kernel_count(k) for k in names]
    wide = nv_on(cuda, w=642, seed=9)[:, :, :640]                  # rows not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        preprocess_fused_nv_batch(wide, NV_RECT, OUT)
    for bad in (nv.float(), nv[:, :-1], nv[:, :, :-1]):            # dtype, Hb % 3, odd width
        with pytest.raises(ValueError):
            preprocess_fused_nv_batch(bad, None, OUT)
    buf = nv[0]
    with pytest.raises(ValueError, match="contiguous"):
        nv_to_bgr(buf[:360, ::2], buf[360:, ::2], is_nv12=False)
    with pytest.raises(ValueError, match="uint8"):
        nv_to_bgr(buf[:360].float(), buf[360:].float(), is_nv12=False)
    with pytest.raises(ValueError, match="even width"):
        nv_to_bgr(buf[:360, :-1], buf[360:, :-1], is_nv12=False)
    with pytest.raises(ValueError, match="needs 180"):
        nv_to_bgr(buf[:360], buf[360:500], is_nv12=False)
    x = torch.rand((3, 64, 80), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        normalize_fused(x.transpose(1, 2))
    with pytest.raises(ValueError, match="uint8 or float32"):
        normalize_fused(x.to(torch.int32))
    with pytest.raises(ValueError):
        normalize_fused(x[0])
    assert [config.kernel_count(k) for k in names] == before
