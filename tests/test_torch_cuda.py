"""The CUDA kernels on the card: ``pytest -m gpu tests/test_torch_cuda.py``.

Each test takes the ``cuda`` fixture, which skips when PyTorch sees no
CUDA device, so on a CPU-only host the whole file skips.  Each kernel is
held to its plain PyTorch version on the same CUDA tensors: the fused
preprocess kernels to cosine >= 1-1e-6 and max-abs < 0.05 normalized,
and at most 1 LSB on under 1e-3 of the values with ``normalize=False``;
yuv2bgr bit-exact; normalize to cosine >= 1-1e-6 and max-abs < 1e-4; the
warp kernel bit-exact on u8 and within 5e-3 on f32; the correlation kernel
within 1e-5 of the largest response magnitude; the tensor-core probe
bit-exact with the probe's integer operands and, on random bf16 operands,
within 1e-5 of the largest sum of product magnitudes.
"""
import numpy as np
import pytest
import torch

import vacv_tpu_torch as vt
from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import ColorCode, InterMode, VRect
from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
from vacv_tpu_torch.ops.cuda.match_template import corr_planes, corr_planes_torch
from vacv_tpu_torch.ops.cuda.normalize import normalize_fused
from vacv_tpu_torch.ops.cuda.probe import probe_dot, probe_dot_torch
from vacv_tpu_torch.ops.cuda.preprocess import (
    preprocess_fused_batch,
    preprocess_fused_batch_torch,
    preprocess_fused_nv_batch,
    preprocess_fused_nv_batch_torch,
)
from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch, warp_planes_batch_torch
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


# ---- the warp kernel ------------------------------------------------------

M_ROT = np.array([[0.9, 0.03, 40.0], [-0.03, 0.9, 25.0]], np.float32)
WARP_MATRICES = {
    "rotation": vt.invert_affine(M_ROT),
    "rot30": vt.invert_affine(vt.get_rotation_matrix_2d(vt.VPoint(320, 180), 30.0, 1.1)),
    "axis_flip": vt.invert_affine(np.array([[-1.25, 0, 700.0], [0, 0.75, 10.0]], np.float32)),
    "mostly_out": vt.invert_affine(np.array([[0.5, 0, 500.0], [0, 0.5, 300.0]], np.float32)),
}
BORDERS = [vt.BORDER_CONSTANT, vt.BORDER_REPLICATE, vt.BORDER_REFLECT, vt.BORDER_WRAP,
           vt.BORDER_REFLECT_101]


def assert_warp_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.uint8:
        assert torch.equal(got, want), (got.int() - want.int()).abs().max().item()
    else:
        assert (got - want).abs().max().item() <= 5e-3


@pytest.mark.parametrize("matrix", list(WARP_MATRICES))
@pytest.mark.parametrize("interp", [vt.INTER_LINEAR, vt.INTER_NEAREST, vt.INTER_CUBIC],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("border", BORDERS, ids=lambda b: b.name)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["u8", "f32"])
def test_warp_kernel_matches_plain_version(cuda, matrix, interp, border, dtype):
    planes = batch_on(cuda, n=2, seed=10).permute(0, 3, 1, 2).to(dtype)
    kw = dict(interp=interp, border=border, border_value=17.0)
    minv = WARP_MATRICES[matrix]
    got = warp_planes_batch(planes, minv, 215, 283, **kw)
    torch.cuda.synchronize()
    assert_warp_close(got, warp_planes_batch_torch(planes, minv, 215, 283, **kw))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.float16],
                         ids=["u8", "f32", "f16"])
def test_warp_affine_on_the_card_matches_the_cpu(cuda, dtype):
    """warp_affine through every flag on a CUDA HWC image against the
    same call on the CPU (the plain version)."""
    img = batch_on(cuda, n=1, seed=11)[0].to(dtype)
    for args in [
        (M_ROT, (283, 215)),
        (M_ROT, (283, 215), vt.INTER_LINEAR, vt.BORDER_TRANSPARENT, 9.0),
        (vt.invert_affine(M_ROT), (283, 215), int(vt.INTER_CUBIC) | int(vt.WARP_INVERSE_MAP)),
        (M_ROT, (283, 215), vt.INTER_NEAREST,
         int(vt.BORDER_REFLECT) | int(vt.BORDER_ISOLATED), vt.VScalar(3.0)),
    ]:
        got = vt.warp_affine(img, *args)
        want = vt.warp_affine(img.cpu(), *args)
        assert got.data.device == cuda and got.data.is_contiguous()
        if dtype == torch.float16:
            assert (got.data.float().cpu() - want.data.float()).abs().max().item() <= 0.125
        else:
            assert_warp_close(got.data.cpu(), want.data)
    got = vt.warp_affine(img, M_ROT, (283, 215), edge_mode="vacv").data.cpu()
    assert_warp_close(got, vt.warp_affine(img.cpu(), M_ROT, (283, 215), edge_mode="vacv").data)


def test_warp_counter_routes_and_raises(cuda):
    planes = batch_on(cuda, n=2, seed=12).permute(0, 3, 1, 2)
    minv = WARP_MATRICES["rotation"]
    names = ("warp_affine", "warp_affine_torch")
    before = [config.kernel_count(k) for k in names]
    warp_planes_batch(planes, minv, 64, 64)
    warp_planes_batch(planes.float(), minv, 64, 64, interp=vt.INTER_CUBIC)
    warp_planes_batch(planes.cpu(), minv, 64, 64)
    with config.backend("torch"):
        vt.warp_affine(planes[0], M_ROT, (64, 64))  # the plain gather, by request
    torch.cuda.synchronize()
    assert [config.kernel_count(k) - b for k, b in zip(names, before)] == [2, 1]
    with pytest.raises(ValueError):
        warp_planes_batch(planes.to(torch.int32), minv, 64, 64)
    with pytest.raises(ValueError):
        warp_planes_batch(planes, minv, 64, 64, border=vt.BORDER_TRANSPARENT)
    assert config.kernel_count("warp_affine") - before[0] == 2


def test_preprocessor_config5_launches_one_warp_per_batch(cuda):
    cfg = PreprocessConfig(crop_rect=VRect(20, 10, 620, 350),
                           warp=(tuple(map(tuple, M_ROT)), (304, 171)), out_size=(96, 96))
    pre = Preprocessor(cfg, device="cuda")
    batch = batch_on(cuda, n=3, seed=13)
    assert pre.describe_route(batch.shape[1:]) == "cuda_warp"
    names = ("warp_affine", "normalize_fused", "warp_affine_torch", "normalize_fused_torch")
    before = [config.kernel_count(k) for k in names]
    got = pre.batch(batch, top=torch.tensor(7, device=cuda))
    torch.cuda.synchronize()
    assert [config.kernel_count(k) - b for k, b in zip(names, before)] == [1, 3, 0, 0]
    with config.backend("torch"):
        want = pre.batch(batch, top=torch.tensor(7, device=cuda))
    assert_close(got, want, "self")


# ---- the correlation kernel -----------------------------------------------

def rand_on(device, shape, seed, lo=0, hi=256, frac=False):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if frac:
        return torch.rand(shape, generator=g, device=device) * 2 - 1
    return torch.randint(lo, hi, shape, generator=g, device=device).to(torch.float32)


@pytest.mark.parametrize("c,h,w,th,tw,frac", [
    (3, 720, 1280, 48, 48, False), (3, 360, 640, 32, 32, False), (3, 200, 300, 21, 17, True),
    (1, 120, 300, 7, 129, False), (2, 260, 260, 200, 220, False), (5, 40, 50, 1, 1, True),
])
def test_corr_kernel_matches_conv2d(cuda, c, h, w, th, tw, frac):
    """Held to the exact (float64) correlation within 1e-5 of the largest
    response, and to conv2d in f32 where its own f32 sums stay inside that
    bar (up to 16384 terms; cuDNN's error grows with the term count)."""
    x = rand_on(cuda, (c, h, w), seed=h + w, frac=frac)
    k = rand_on(cuda, (c, th, tw), seed=th + tw, frac=frac)
    got = corr_planes(x, k)
    want = corr_planes_torch(x, k)
    exact = torch.nn.functional.conv2d(x.double()[None], k.double()[None])[0, 0]
    torch.cuda.synchronize()
    assert got.shape == want.shape == (h - th + 1, w - tw + 1)
    scale = exact.abs().max().item()
    assert (got.double() - exact).abs().max().item() <= 1e-5 * scale
    if c * th * tw <= 16384:
        assert (got - want).abs().max().item() <= 1e-5 * scale


def test_corr_kernel_reads_strided_images(cuda):
    hwc = rand_on(cuda, (100, 140, 3), seed=3)
    k = rand_on(cuda, (3, 9, 11), seed=4)
    got = corr_planes(hwc.permute(2, 0, 1), k)
    want = corr_planes_torch(hwc.permute(2, 0, 1).contiguous(), k)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("mode", [vt.TM_SQDIFF, vt.TM_SQDIFF_NORMED, vt.TM_CCORR,
                                  vt.TM_CCORR_NORMED, vt.TM_CCOEFF, vt.TM_CCOEFF_NORMED],
                         ids=lambda m: m.name)
def test_match_template_on_the_card(cuda, mode):
    img = batch_on(cuda, n=1, seed=14)[0]
    tmpl = img[100:140, 200:236].clone()
    before = config.kernel_count("match_corr")
    got = vt.match_template(img, tmpl, mode).data
    torch.cuda.synchronize()
    assert config.kernel_count("match_corr") == before + 1
    want = vt.match_template(img.cpu(), tmpl.cpu(), mode).data
    scale = 1.0 if mode in (vt.TM_SQDIFF_NORMED, vt.TM_CCORR_NORMED, vt.TM_CCOEFF_NORMED) \
        else want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * scale
    _, _, _, (x, y) = vt.min_max_loc(got)
    if mode != vt.TM_SQDIFF and mode != vt.TM_SQDIFF_NORMED and mode != vt.TM_CCORR:
        assert (int(x), int(y)) == (200, 100)


# ---- the tensor-core probe ------------------------------------------------

PROBE_SHAPES = [  # (m, k, n, reps): every shape of benchmarks/probe_i8.py, then ragged ones
    (96, 128, 2048, 64), (96, 32, 1024, 64), (96, 64, 1024, 64), (96, 96, 1024, 64),
    (96, 128, 1024, 64), (1024, 1024, 1024, 32),
    (37, 64, 75, 5), (17, 96, 9, 1), (70, 160, 130, 70), (1, 32, 8, 2), (65, 224, 129, 3),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "i8"])
@pytest.mark.parametrize("m,k,n,reps", PROBE_SHAPES)
def test_probe_kernel_is_bit_exact_on_the_probe_operands(cuda, dtype, m, k, n, reps):
    g = torch.Generator(device=cuda)
    g.manual_seed(m + k + n + reps)
    a = torch.randint(-100, 100, (m + reps, k), generator=g, device=cuda).to(dtype)
    b = torch.randint(-2, 3, (k, n), generator=g, device=cuda).to(dtype)
    k0 = config.kernel_count("probe_dot")
    got = probe_dot(a, b, reps)
    torch.cuda.synchronize()
    assert config.kernel_count("probe_dot") == k0 + 1
    want = probe_dot_torch(a, b, reps)
    assert got.dtype == want.dtype and got.shape == (m, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n,reps", [(96, 128, 2048, 64), (45, 48, 77, 7)])
def test_probe_kernel_on_random_bf16(cuda, m, k, n, reps):
    """f32 sums of K·reps products in another order than the f64 plain
    version: within 1e-5 of the largest Σ|a||b| (worst case K·reps·2^-24)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    a = torch.randn(m + reps, k, generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn(k, n, generator=g, device=cuda).to(torch.bfloat16)
    got = probe_dot(a, b, reps).double()
    want = probe_dot_torch(a, b, reps).double()
    mag = probe_dot_torch(a.abs(), b.abs(), reps).double().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * mag


def test_probe_kernel_reads_a_shifted_window(cuda):
    a2 = torch.randint(-100, 100, (96 + 64 + 1, 128), device=cuda).to(torch.int8)
    b = torch.randint(-2, 3, (128, 256), device=cuda).to(torch.int8)
    for i in (0, 1):
        win = a2[i : i + 96 + 64]
        assert torch.equal(probe_dot(win, b, 64), probe_dot_torch(win, b, 64))


def test_probe_device_time_is_positive_on_the_card(cuda):
    from vacv_tpu_torch.profile import probe_i8
    from vacv_tpu_torch.utils.perf import device_time

    a2 = torch.randint(-100, 100, (96 + 64 + 1, 128), device=cuda).to(torch.int8)
    b = torch.randint(-2, 3, (128, 1024), device=cuda).to(torch.int8)
    assert device_time(probe_i8.step, a2, b, 64) > 0


def test_numpy_batch_goes_to_the_card_by_default(cuda):
    """Preprocessor(cfg) and the facade ops put a numpy input on cuda:0."""
    cfg = PreprocessConfig(crop_rect=RECT, out_size=OUT)
    pre = Preprocessor(cfg)
    assert pre.describe_route((360, 640, 3)) == "cuda_fused"
    batch = batch_on("cpu").numpy()
    k0 = config.kernel_count("preprocess_fused")
    out = pre.batch(batch)
    assert out.device == cuda and config.kernel_count("preprocess_fused") == k0 + 1
    assert vt.normalize(batch[0].astype(np.float32)).data.device == cuda
    with config.device("cpu"):
        assert Preprocessor(cfg).batch(batch).device.type == "cpu"
