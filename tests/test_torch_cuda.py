"""The CUDA kernels on the card: ``pytest -m gpu tests/test_torch_cuda.py``.

Each test takes the ``cuda`` fixture, which skips when PyTorch sees no
CUDA device, so on a CPU-only host the whole file skips.  Each kernel is
held to its plain PyTorch version on the same CUDA tensors: the fused
preprocess kernels to cosine >= 1-1e-6 and max-abs < 0.05 normalized,
and at most 1 LSB on under 1e-3 of the values with ``normalize=False``;
yuv2bgr bit-exact; normalize to cosine >= 1-1e-6 and max-abs < 1e-4, in
both launch forms, from aligned and misaligned bases, one kernel launch a
call and the same bits on a second call; the warp kernel bit-exact on u8
and f32 through each of its three paths (within 5e-3 on f32 in the older
sweep), its 3-channel u8 HWC form at config 5 (16 frames, both clamps of
a device top), at every base alignment and under every border rule, and
``warp.hwc3_launches`` against the kernel the profiler saw (none for a
config-5 batch, which takes the fused warp); the correlation kernel
within 1e-5 of the largest response magnitude; the tensor-core probe
bit-exact with the probe's integer operands and, on random bf16 operands,
within 1e-5 of the largest sum of product magnitudes.  The tracer's
counters on the card: one call into the kernel library a config-4 batch,
one a config-5 batch (the fused warp), and a served 1080p frame's 6,220,800 bytes.  The
launch records of ``Preprocessor.batch``: a hit, a miss and the public
wrappers bit for bit on each CUDA route, with None, int and tensor tops
changing every call, on ``StreamExecutor``'s four lane streams and with
Preprocessors in turns.
"""
import dataclasses

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
    preprocess_fused_batch(batch, RECT, OUT)                       # the moments form: two launches
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


# ---- the config-4 moments form ----------------------------------------------

C4_STATS = {"self": {}, "static_mean": dict(mean=(104.0, 117.0, 123.0)),
            "static_stddev": dict(stddev=(57.1, 57.4, 58.4))}


@pytest.mark.parametrize("interp", ["linear", "cubic", "nearest"])
@pytest.mark.parametrize("stats", list(C4_STATS))
def test_config4_moments_form_is_its_integer_statistics(cuda, interp, stats):
    """The moments form: the plain version's output (cosine),
    and bit for bit (raw − μ) · (1 / (σ + 1e-6)) with the host twin's
    statistics over the ``normalize=False`` output, which is the plain
    version's bit for bit; the same bits on a second call."""
    from vacv_tpu_torch.ops.cuda.preprocess import one_pass_stats

    kw = C4_STATS[stats]
    batch = batch_on(cuda, n=3, seed=20)
    raw = preprocess_fused_batch(batch, RECT, OUT, interp=interp, normalize=False)
    assert torch.equal(raw, preprocess_fused_batch_torch(batch, RECT, OUT, interp=interp,
                                                         normalize=False))
    got = preprocess_fused_batch(batch, RECT, OUT, interp=interp, **kw)
    want = preprocess_fused_batch_torch(batch, RECT, OUT, interp=interp, **kw)
    assert cosine(got, want) >= 1 - 1e-6 and (got - want).abs().max().item() < 0.05
    mu, inv = one_pass_stats(raw, kw.get("mean"), kw.get("stddev"))
    assert torch.equal(got, (raw - mu[..., None, None]) * inv[..., None, None])
    assert torch.equal(got, preprocess_fused_batch(batch, RECT, OUT, interp=interp, **kw))


def test_config4_self_stats_write_f32_once(cuda):
    """Self statistics at the config-4 shape: the resize kernel (u8 planes)
    and the scale kernel, no normalize kernel reading the f32 planes back."""
    from torch.profiler import ProfilerActivity, profile

    batch = batch_on(cuda, n=8, h=1080, w=1920, seed=21)
    rect = VRect(64, 28, 64 + 1792, 28 + 1036)
    preprocess_fused_batch(batch, rect, (224, 224))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            preprocess_fused_batch(batch, rect, (224, 224))
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sorted(kernels.values()) == [5, 5], kernels
    assert any("moments_resize_kernel" in k for k in kernels), kernels
    assert any("scale_u8_kernel" in k for k in kernels), kernels

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


def nv_view(device, h, w, view, seed):
    """Y and VU planes of a stacked NV buffer on the card: "stacked" (one
    contiguous buffer), "odd_offset" (the buffer one byte above an aligned
    allocation), "strided" (rows 2048 bytes apart, or 8 past the width)."""
    rows = h + (h + 1) // 2
    pitch = {"stacked": w, "odd_offset": w, "strided": max(2048, w + 8)}[view]
    offset = 1 if view == "odd_offset" else 0
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randint(0, 256, (rows * pitch + offset,), generator=g, dtype=torch.uint8,
                         device=device)
    buf = flat[offset:].view(rows, pitch)[:, :w]
    return buf[:h], buf[h:]


@pytest.mark.parametrize("view", ["stacked", "odd_offset", "strided"])
@pytest.mark.parametrize("is_nv12", [False, True])
@pytest.mark.parametrize("h,w", [(2160, 3840), (1080, 1920), (1079, 1920), (720, 1280),
                                 (144, 176), (1079, 284), (215, 284), (1080, 1928), (3, 6),
                                 (1, 2)])
def test_yuv2bgr_kernel_is_bit_exact(cuda, is_nv12, h, w, view):
    """Every vector width (8 at 4K, 1080p and a 1928 width, 4 at 720p and
    a 284 width, 2 at 144x176, an odd base or a tiny frame), odd heights
    and strided views."""
    from vacv_tpu_torch.ops.cuda.yuv2bgr import vector_width

    y, vu = nv_view(cuda, h, w, view, seed=3)
    got = nv_to_bgr(y, vu, is_nv12=is_nv12)
    want = nv_to_bgr_planes_torch(y, vu, is_nv12=is_nv12)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.device == cuda and torch.equal(a, b)
    v = vector_width(h, w, y.data_ptr(), y.stride(0), vu.data_ptr(), vu.stride(0),
                     got[0].data_ptr())
    if view == "odd_offset":
        assert v == 2
    elif view == "stacked":
        assert v == {(2160, 3840): 8, (1080, 1920): 8, (720, 1280): 4, (144, 176): 2}.get((h, w), v)


def test_yuv2bgr_is_one_launch_a_call(cuda):
    from torch.profiler import ProfilerActivity, profile

    y, vu = nv_view(cuda, 1080, 1920, "stacked", seed=4)
    nv_to_bgr(y, vu, is_nv12=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            nv_to_bgr(y, vu, is_nv12=False)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sum(kernels.values()) == 5 and "yuv2bgr" in next(iter(kernels)), kernels


# ---- the NV one-pass form -------------------------------------------------

NV_STATS = {"self": {}, "static_mean": dict(mean=(104.0, 117.0, 123.0)),
            "static_stddev": dict(stddev=(57.1, 57.4, 58.4))}


def assert_one_pass(nv, rect, out, **kw):
    """The one-pass form (as the plan picks it) against the plain version
    (cosine >= 1-1e-6, max-abs < 1e-4), bit for bit against the host twin
    of its statistics over the normalize=False output (so its u8 values are
    those), at cosine >= 1-1e-6 against the forced two-launch form, and the
    same bits on a second call."""
    from vacv_tpu_torch.ops.cuda import preprocess as pk

    n, oh, ow = nv.shape[0], out[1], out[0]
    plan = pk.launch_plan(n, oh, ow, pk.card_limits(0))
    assert plan.form == "one_pass"
    got = preprocess_fused_nv_batch(nv, rect, out, **kw)
    raw = preprocess_fused_nv_batch(nv, rect, out, normalize=False, **kw)
    two = preprocess_fused_nv_batch(nv, rect, out, form="two_launch", **kw)
    again = preprocess_fused_nv_batch(nv, rect, out, **kw)
    want = preprocess_fused_nv_batch_torch(nv, rect, out, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, 3, oh, ow) and bool(torch.isfinite(got).all())
    assert cosine(got, want) >= 1 - 1e-6 and (got - want).abs().max().item() < 1e-4
    mu, inv = pk.one_pass_stats(raw, kw.get("mean"), kw.get("stddev"))
    assert torch.equal(got, (raw - mu[..., None, None]) * inv[..., None, None])
    assert cosine(got, two) >= 1 - 1e-6
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("is_nv12", [False, True])
@pytest.mark.parametrize("to_rgb", [False, True])
@pytest.mark.parametrize("stats", list(NV_STATS))
def test_nv_one_pass_matches_plain_version_and_its_twin(cuda, is_nv12, to_rgb, stats):
    nv = nv_on(cuda, n=3, seed=10)
    assert_one_pass(nv, NV_RECT, OUT, is_nv12=is_nv12, to_rgb=to_rgb, **NV_STATS[stats])


@pytest.mark.parametrize("h,w,rect,out", [
    (144, 176, None, (176, 144)),           # config 2's frame, not resized
    (214, 284, VRect(11, 7, 271, 203), (224, 224)),
    (2, 2, None, (224, 224)),
    (720, 1280, VRect(0, 200, 1280, 520), (224, 224)),   # the tracking ROI
    (360, 640, VRect(1, 3, 640, 360), (99, 37)),         # a width with no float4 rows
])
def test_nv_one_pass_odd_frames(cuda, h, w, rect, out):
    assert_one_pass(nv_on(cuda, n=2, h=h, w=w, seed=11), rect, out)


@pytest.mark.parametrize("top", [0, 1, 37, 120, 10_000])
def test_nv_one_pass_runtime_top(cuda, top):
    nv = nv_on(cuda, n=2, seed=12)
    dev = preprocess_fused_nv_batch(nv, NV_RECT, OUT, top=torch.tensor(top, device=cuda))
    host = preprocess_fused_nv_batch(nv, NV_RECT, OUT, top=top)
    torch.cuda.synchronize()
    assert torch.equal(dev, host)
    assert_one_pass(nv, NV_RECT, OUT, top=min(top, 360 - 224))


@pytest.mark.parametrize("blocks", [1, 2, 4, 8, 16, 32, 64])
def test_nv_one_pass_blocks_give_the_same_bits(cuda, blocks):
    """Every count of blocks a frame the plan may take: the same bits."""
    from vacv_tpu_torch.ops.cuda import preprocess as pk

    nv = nv_on(cuda, n=3, seed=13)
    plan = pk.one_pass_plan(3, OUT[1], OUT[0], pk.card_limits(0), blocks)
    assert plan is not None and plan.blocks == blocks
    geom = pk._nv_geometry(nv, NV_RECT, OUT, None)
    got = pk._prepare(nv, geom, (False, False), None, None, None, True, True, "linear",
                      "preprocess_fused_nv", plan=plan).run(nv)
    torch.cuda.synchronize()
    assert torch.equal(got, preprocess_fused_nv_batch(nv, NV_RECT, OUT))


def test_nv_one_pass_is_one_launch_a_call(cuda):
    from torch.profiler import ProfilerActivity, profile

    nv = nv_on(cuda, n=32, h=1080, w=1920, seed=14)
    rect = VRect(64, 28, 64 + 1792, 28 + 1036)
    preprocess_fused_nv_batch(nv, rect, (224, 224))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            preprocess_fused_nv_batch(nv, rect, (224, 224))
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sum(kernels.values()) == 5 and "nv_one_pass" in next(iter(kernels)), kernels


def test_nv_one_pass_refuses_calls_it_cannot_serve(cuda):
    nv = nv_on(cuda, seed=15)
    for kw in (dict(trunc_u8=False), dict(normalize=False),
               dict(mean=(1.0, 2.0, 3.0), stddev=(4.0, 5.0, 6.0))):
        with pytest.raises(ValueError):
            preprocess_fused_nv_batch(nv, NV_RECT, OUT, form="one_pass", **kw)


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


NORM_ODD_SHAPES = [(1, 1, 1), (3, 37, 61), (2, 1, 65521), (64, 37, 64), (5, 13, 17),
                   (2, 255, 257), (1, 300, 300), (150, 260, 260), (3, 224, 224)]


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8], ids=["f32", "u8"])
@pytest.mark.parametrize("shape", NORM_ODD_SHAPES)
def test_normalize_kernel_odd_sizes_forms_and_bases(cuda, shape, dtype, offset):
    """One element, h*w no multiple of 4, a prime, 64 planes, a plane just
    too large for a cluster, more planes than resident blocks: from a base
    ``offset`` elements above a 16-byte boundary (a contiguous slice), in
    every launch form the plane allows; the same bits on a second call."""
    from vacv_tpu_torch.ops.cuda import normalize as nm

    n = int(np.prod(shape))
    g = torch.Generator(device=cuda)
    g.manual_seed(n + offset)
    buf = torch.randint(0, 256, (n + offset,), generator=g, device=cuda).to(dtype)
    x = buf[offset:].view(shape)
    want = normalize_torch(vt.Image(x, vt.CHW)).data
    plan = nm.launch_plan(shape[0], shape[1] * shape[2], x.element_size(), nm._limits(0))
    for form in (("cluster", "grid") if plan.form == "cluster" else ("grid",)):
        got = normalize_fused(x, form=form)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == shape
        assert bool(torch.isfinite(got).all()) and (got - want).abs().max().item() < 1e-4
        if shape[1] * shape[2] > 1:
            assert cosine(got, want) >= 1 - 1e-6
        assert torch.equal(normalize_fused(x, form=form), got)
    if plan.form == "grid":
        with pytest.raises(ValueError, match="does not fit"):
            normalize_fused(x, form="cluster")


def test_normalize_slices_larger_than_shared_memory(cuda):
    """A 99.5 MB input: each block keeps what fits of its slice on the SM
    and reads the rest again."""
    from vacv_tpu_torch.ops.cuda import normalize as nm

    x = torch.rand((3, 2160, 3840), device=cuda) * 255
    plan = nm.launch_plan(3, 2160 * 3840, 4, nm._limits(0))
    assert plan.form == "grid" and plan.cap < plan.slice
    got = normalize_fused(x)
    want = normalize_torch(vt.Image(x, vt.CHW)).data
    assert (got - want).abs().max().item() < 1e-4
    assert torch.equal(normalize_fused(x), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8], ids=["f32", "u8"])
@pytest.mark.parametrize("shape", [(3, 224, 224), (3, 1080, 1920)])
def test_normalize_is_one_kernel_launch_a_call(cuda, shape, dtype):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randint(0, 256, shape, device=cuda).to(dtype)
    normalize_fused(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            normalize_fused(x)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sum(kernels.values()) == 5 and len(kernels) == 1, kernels
    assert "normalize_" in next(iter(kernels))


def test_new_launch_counters_rise_once_per_call(cuda):
    nv = nv_on(cuda, seed=5)
    names = ("preprocess_fused_nv", "yuv2bgr", "normalize_fused",
             "preprocess_fused_nv_torch", "yuv2bgr_torch", "normalize_fused_torch")
    before = {k: config.kernel_count(k) for k in names}
    preprocess_fused_nv_batch(nv, NV_RECT, OUT)                  # the one-pass form
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


def assert_warp_paths_exact(planes, minv, h_out, w_out, **kw):
    """Bit-exact to the plain version through each of the kernel's paths."""
    from vacv_tpu_torch.ops.cuda.warp_affine import PATHS

    want = warp_planes_batch_torch(planes, minv, h_out, w_out, **kw)
    for path in PATHS:
        got = warp_planes_batch(planes, minv, h_out, w_out, path=path, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), (path, kw, np.asarray(minv))


@pytest.mark.parametrize("layout", ["hwc_odd_left", "planar_5ch", "hwc_f32", "planes_x_stride_2"])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (5, 7), (37, 53), (215, 283), (360, 640)])
def test_warp_kernel_paths_on_fuzz_matrices(cuda, h, w, layout):
    """Seeded maps (rotate, scale, flip, overshoot past both edges), every
    interpolation and border, sizes from one pixel up, sources the kernel
    stages (an HWC view from an odd left, planes), stages rarely (f32) and
    never stages (strided planes): u8 and f32 bit-exact on every path."""
    from vacv_tpu_torch.ops.cuda.warp_affine import tile_paths
    from vacv_tpu_torch.utils.fuzz import affine_matrices

    img = batch_on(cuda, n=2, h=h, w=2 * w + 1, seed=h + w)
    src = {
        "hwc_odd_left": img[:, :, 1:w + 1].permute(0, 3, 1, 2),
        "planar_5ch": torch.cat([img, img[..., :2]], -1)[:, :, :w].permute(0, 3, 1, 2).contiguous(),
        "hwc_f32": img[:, :, :w].permute(0, 3, 1, 2).float(),
        "planes_x_stride_2": img.permute(0, 3, 1, 2).contiguous()[..., 0:2 * w:2],
    }[layout]
    assert src.shape[2:] == (h, w)
    h_out, w_out = max(1, h * 4 // 5), max(1, w * 5 // 4)
    reached = {"staged": 0, "direct": 0, "edge": 0}
    for m in affine_matrices(h * 1000 + w, h, w, h_out, w_out, 4):
        for interp in (vt.INTER_LINEAR, vt.INTER_NEAREST, vt.INTER_CUBIC):
            for border in BORDERS:
                assert_warp_paths_exact(src, m, h_out, w_out, interp=interp, border=border,
                                        border_value=9.0)
            for k, v in tile_paths(src, m, h_out, w_out, interp).items():
                reached[k] += v
        assert_warp_paths_exact(src, m, h_out, w_out, edge_mode="vacv", border_value=3.0)
    assert reached["edge"] > 0
    if layout == "planes_x_stride_2":
        assert reached["staged"] == 0
    elif (h, w) == (360, 640):
        assert reached["staged"] > 0 and reached["direct"] > 0


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("interp", [vt.INTER_LINEAR, vt.INTER_NEAREST, vt.INTER_CUBIC],
                         ids=lambda m: m.name)
def test_warp_kernel_paths_at_config_5(cuda, interp, dtype):
    """BASELINE config 5's geometry (two 2560x1440 frames, the crop as an
    HWC view, the rotated map to 1216x684): nearly every tile interior,
    staged by the cubic kernel and read directly by the others."""
    from vacv_tpu_torch.ops.cuda.warp_affine import tile_paths

    batch = batch_on(cuda, n=2, h=1440, w=2560, seed=15)
    crop = batch[:, 36:1404, 64:2496].permute(0, 3, 1, 2).to(dtype)
    minv = vt.invert_affine(M_ROT)
    tiles = tile_paths(crop, minv, 684, 1216, interp)
    taken, other = ("staged", "direct") if interp == vt.INTER_CUBIC else ("direct", "staged")
    assert tiles[taken] > 0.9 * sum(tiles.values()) and tiles[other] == 0
    for border in (vt.BORDER_CONSTANT, vt.BORDER_REFLECT_101):
        assert_warp_paths_exact(crop, minv, 684, 1216, interp=interp, border=border)
    planar = crop.contiguous()
    assert tile_paths(planar, minv, 684, 1216, interp) == tiles
    assert_warp_paths_exact(planar, minv, 684, 1216, interp=interp)


def test_warp_rejects_an_unknown_path(cuda):
    planes = batch_on(cuda, n=2, seed=16).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="path"):
        warp_planes_batch(planes, WARP_MATRICES["rotation"], 64, 64, path="fastest")


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
    names = ("preprocess_fused_warp", "warp_affine", "preprocess_fused_planar", "normalize_fused",
             "warp_affine_torch", "preprocess_fused_planar_torch", "normalize_fused_torch")
    before = [config.kernel_count(k) for k in names]
    got = pre.batch(batch, top=torch.tensor(7, device=cuda))
    torch.cuda.synchronize()
    # One fused warp call a batch (the warp sampled inside the planar tail's
    # resize), no warp launch of its own, no normalize a frame.
    assert [config.kernel_count(k) - b for k, b in zip(names, before)] == [1, 0, 0, 0, 0, 0, 0]
    with config.backend("torch"):
        want = pre.batch(batch, top=torch.tensor(7, device=cuda))
    assert_close(got, want, "self")


@pytest.mark.parametrize("top", [36, 0, 72, -5, 400])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("layout", ["hwc", "planar"])
def test_warp_kernel_reads_a_device_top(cuda, top, dtype, layout):
    """``row0``/``rows`` at config 5's geometry: the kernel on the uncut
    frames against the plain version on the planes cut at the clamped top,
    bit for bit, one launch a call and no other kernel."""
    batch = batch_on(cuda, n=2, h=1440, w=2560, seed=17)[:, :, 64:2496]
    planes = batch.permute(0, 3, 1, 2).to(dtype)
    if layout == "planar":
        planes = planes.contiguous()
    minv = vt.invert_affine(M_ROT)
    t = torch.tensor(top, dtype=torch.int32, device=cuda)
    before = config.kernel_count("warp_affine")
    got = warp_planes_batch(planes, minv, 684, 1216, row0=t, rows=1368)
    torch.cuda.synchronize()
    assert config.kernel_count("warp_affine") == before + 1
    cut = planes[:, :, min(max(top, 0), 72):][:, :, :1368]
    assert torch.equal(got, warp_planes_batch_torch(cut, minv, 684, 1216))
    assert torch.equal(got, warp_planes_batch(cut, minv, 684, 1216))


# ---- the warp kernel's 3-channel u8 HWC linear form -------------------------

def hwc3_launches():
    from vacv_tpu_torch.utils import trace

    return trace.counter("warp.hwc3_launches")


def warp_kernels_launched(fn, n=10):
    """(the names of the warp kernels ``fn()`` launches, from the profiler
    over ``n`` calls; the calls made): a window in which the profiler
    recorded no warp kernel at all is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    calls = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        calls += n
        names = {e.key for e in prof.key_averages() if "warp_kernel" in e.key}
        if names:
            break
    return names, calls


@pytest.mark.parametrize("top", [0, 72, -5, 400])
def test_warp_hwc3_form_at_config_5(cuda, top):
    """BASELINE config 5 at one host's batch (16 frames of 2560x1440, the
    crop an HWC view read at a device top, both clamps): the 3-channel form
    on every path, bit for bit against the plain version, one count of
    ``warp.hwc3_launches`` a call."""
    from vacv_tpu_torch.ops.cuda.warp_affine import PATHS, hwc3_form

    planes = batch_on(cuda, n=16, h=1440, w=2560, seed=18)[:, :, 64:2496].permute(0, 3, 1, 2)
    assert hwc3_form(planes)
    minv = vt.invert_affine(M_ROT)
    t = torch.tensor(top, dtype=torch.int32, device=cuda)
    want = warp_planes_batch_torch(planes, minv, 684, 1216, row0=t, rows=1368)
    before = hwc3_launches()
    for path in PATHS:
        got = warp_planes_batch(planes, minv, 684, 1216, row0=t, rows=1368, path=path)
        torch.cuda.synchronize()
        assert torch.equal(got, want), path
    assert hwc3_launches() == before + len(PATHS)


@pytest.mark.parametrize("w_out", [1216, 1213])
@pytest.mark.parametrize("left", [64, 65])
@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_warp_hwc3_form_at_any_alignment(cuda, base, left, w_out):
    """The 3-channel form from a source base 0 to 3 bytes past a 4-byte
    boundary, at config 5's left and an odd one, into output rows of 1216
    (4-byte stores) and 1213 bytes: bit for bit on every path."""
    from vacv_tpu_torch.ops.cuda.warp_affine import hwc3_form

    n, h, w = 2, 1440, 2560
    size = n * h * w * 3
    g = torch.Generator(device=cuda)
    g.manual_seed(base + left + w_out)
    flat = torch.randint(0, 256, (size + 4,), generator=g, dtype=torch.uint8, device=cuda)
    frames = flat[base:base + size].view(n, h, w, 3)
    assert frames.data_ptr() % 4 == base
    planes = frames[:, 36:1404, left:left + 2432].permute(0, 3, 1, 2)
    assert hwc3_form(planes)
    assert_warp_paths_exact(planes, vt.invert_affine(M_ROT), 684, w_out)


@pytest.mark.parametrize("matrix", ["rotation", "rot30", "mostly_out"])
@pytest.mark.parametrize("rule", ["constant", "reflect_101", "vacv"])
def test_warp_hwc3_form_border_rules(cuda, matrix, rule):
    """The edge tiles of the 3-channel form under BORDER_CONSTANT (border
    value 17), BORDER_REFLECT_101 and the skip-edge mask, at 360x640 from
    an odd left, and at config 5's geometry: bit for bit on every path."""
    from vacv_tpu_torch.ops.cuda.warp_affine import hwc3_form

    kw = {"constant": dict(border=vt.BORDER_CONSTANT, border_value=17.0),
          "reflect_101": dict(border=vt.BORDER_REFLECT_101),
          "vacv": dict(edge_mode="vacv", border_value=9.0)}[rule]
    planes = batch_on(cuda, n=2, h=360, w=641, seed=19)[:, :, 1:].permute(0, 3, 1, 2)
    assert hwc3_form(planes)
    assert_warp_paths_exact(planes, WARP_MATRICES[matrix], 215, 283, **kw)
    if matrix == "rotation":
        big = batch_on(cuda, n=2, h=1440, w=2560, seed=20)[:, 36:1404, 64:2496]
        assert_warp_paths_exact(big.permute(0, 3, 1, 2), vt.invert_affine(M_ROT), 684, 1216, **kw)


def test_warp_hwc3_launches_count_config_5_batches_only(cuda):
    """``warp.hwc3_launches`` rises by one a call of the warp's 3-channel
    HWC form, and not at all for a config-5 batch (it takes the fused warp,
    one ``preprocess_fused_warp`` call a batch, launch-record hits included)
    or for planar, f32, cubic, nearest or 4-channel calls; the kernel the
    profiler sees is the one ``hwc3_form`` names."""
    from vacv_tpu_torch.ops.cuda.warp_affine import hwc3_form
    from vacv_tpu_torch.utils import trace

    pre = Preprocessor(PreprocessConfig(crop_rect=VRect(64, 36, 2496, 1404),
                                        warp=(tuple(map(tuple, M_ROT)), (1216, 684)),
                                        out_size=(224, 224)), device="cuda")
    batch = batch_on(cuda, n=16, h=1440, w=2560, seed=21)
    top = torch.tensor(20, dtype=torch.int32, device=cuda)
    before, hits = hwc3_launches(), trace.counter("pipeline.record_hits")
    fused = config.kernel_count("preprocess_fused_warp")
    for _ in range(3):
        pre.batch(batch, top=top)
    torch.cuda.synchronize()
    assert hwc3_launches() == before
    assert config.kernel_count("preprocess_fused_warp") == fused + 3
    assert trace.counter("pipeline.record_hits") >= hits + 2
    minv = vt.invert_affine(M_ROT)
    hwc = batch[:2, 36:1404, 64:2496].permute(0, 3, 1, 2)
    four = batch_on(cuda, n=2, h=360, w=640, seed=22)
    four = torch.cat([four, four[..., :1]], -1).permute(0, 3, 1, 2)
    calls = {
        "hwc": (hwc, {}),
        "planar": (hwc.contiguous(), {}),
        "f32": (hwc.float(), {}),
        "cubic": (hwc, dict(interp=vt.INTER_CUBIC)),
        "nearest": (hwc, dict(interp=vt.INTER_NEAREST)),
        "4 channels": (four, {}),
    }
    for name, (src, kw) in calls.items():
        form = hwc3_form(src, kw.get("interp", vt.INTER_LINEAR))
        assert form == (name == "hwc"), name
        before = hwc3_launches()
        names, calls = warp_kernels_launched(lambda: warp_planes_batch(src, minv, 300, 400, **kw))
        assert hwc3_launches() == before + calls * int(form), name
        assert names and all(("warp_kernel_hwc3" in k) == form for k in names), (name, names)


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


CORR_SIZES = [1, 7, 33, 48, 65]


@pytest.mark.parametrize("c", [1, 3, 5])
@pytest.mark.parametrize("th", CORR_SIZES)
@pytest.mark.parametrize("tw", CORR_SIZES)
def test_corr_kernel_template_sizes_and_tile_edges(cuda, c, th, tw):
    """Every template height and width against the chunks (48 rows, 24
    columns, padded to 8) and an output that is no multiple of the 32 x 128
    tile; C = 3 and 5 take the channel split on a small image."""
    x = rand_on(cuda, (c, th + 40, tw + 150), seed=c * 100 + th, frac=True)
    k = rand_on(cuda, (c, th, tw), seed=tw, frac=True)
    got = corr_planes(x, k)
    exact = torch.nn.functional.conv2d(x.double()[None], k.double()[None])[0, 0]
    torch.cuda.synchronize()
    assert got.shape == (41, 151)
    assert (got.double() - exact).abs().max().item() <= 1e-5 * exact.abs().max().item()


@pytest.mark.parametrize("c,th,tw", [(3, 9, 11), (5, 48, 48), (3, 130, 70)])
def test_corr_kernel_split_channels_and_large_templates(cuda, c, th, tw):
    """The channel split (``split_plan`` > 1) over a strided HWC image, and a
    template of 3 x 130 x 70 floats (109 KB), larger than the kernel keeps in
    shared memory at once: it comes in 48 x 24 chunks like any other."""
    from vacv_tpu_torch.ops.cuda import match_template as mt

    hwc = rand_on(cuda, (th + 200, tw + 300, c), seed=th + c)
    k = rand_on(cuda, (c, th, tw), seed=tw + c)
    assert mt.split_plan(201, 301, c, torch.cuda.get_device_properties(0).multi_processor_count) > 1
    got = corr_planes(hwc.permute(2, 0, 1), k)
    exact = torch.nn.functional.conv2d(hwc.permute(2, 0, 1).double()[None], k.double()[None])[0, 0]
    assert (got.double() - exact).abs().max().item() <= 1e-5 * exact.abs().max().item()


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
    before, before_sums = config.kernel_count("match_corr"), config.kernel_count("window_sum")
    got = vt.match_template(img, tmpl, mode).data
    torch.cuda.synchronize()
    assert config.kernel_count("match_corr") == before + 1
    sums = 0 if mode in (vt.TM_CCORR, vt.TM_CCOEFF) else 1
    assert config.kernel_count("window_sum") == before_sums + sums  # both sums in one launch
    want = vt.match_template(img.cpu(), tmpl.cpu(), mode).data
    scale = 1.0 if mode in (vt.TM_SQDIFF_NORMED, vt.TM_CCORR_NORMED, vt.TM_CCOEFF_NORMED) \
        else want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * scale
    _, _, _, (x, y) = vt.min_max_loc(got)
    if mode != vt.TM_SQDIFF and mode != vt.TM_SQDIFF_NORMED and mode != vt.TM_CCORR:
        assert (int(x), int(y)) == (200, 100)


# ---- the window-sum kernel ------------------------------------------------

@pytest.mark.parametrize("c,h,w,th,tw,layout", [
    (3, 720, 1280, 48, 48, "hwc"), (3, 720, 1280, 48, 48, "chw"), (1, 1, 1, 1, 1, "chw"),
    (3, 97, 161, 65, 33, "hwc"), (2, 120, 300, 7, 129, "chw"), (1, 40, 300, 40, 300, "chw"),
    (3, 37, 61, 1, 61, "hwc"), (5, 64, 70, 64, 1, "chw"),
])
@pytest.mark.parametrize("frac", [False, True], ids=["u8", "f32"])
def test_window_sum_kernel_matches_plain_version(cuda, c, h, w, th, tw, layout, frac):
    """Σ_c x² and the per-channel window sums against the ones-band
    products, within 1e-5 of the largest sum, in one launch for both; the
    per-channel sums of u8 values equal; either sum alone the same bits."""
    from vacv_tpu_torch.ops.cuda.window_sum import window_sums, window_sums_torch

    x = rand_on(cuda, (c, h, w), seed=h + tw, frac=frac)
    if layout == "hwc":  # the planes of an interleaved image, as match_template passes them
        x = x.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    before = config.kernel_count("window_sum")
    sq, sums = window_sums(x, th, tw, sq=True, sums=True)
    torch.cuda.synchronize()
    assert config.kernel_count("window_sum") == before + 1
    want_sq, want_sums = window_sums_torch(x, th, tw, sq=True, sums=True)
    for got, want in ((sq, want_sq), (sums, want_sums)):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert (got - want).abs().max().item() <= 1e-5 * max(want.abs().max().item(), 1e-30)
    if not frac:
        assert torch.equal(sums, want_sums)
    assert torch.equal(window_sums(x, th, tw)[0], sq)
    assert torch.equal(window_sums(x, th, tw, sq=False, sums=True)[1], sums)


@pytest.mark.parametrize("kind", ["flat", "low variance"])
@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_window_sum_kernel_on_flat_and_low_variance_images(cuda, kind, layout):
    """The tracking frame's 720p x 48^2 on a flat image (every window the
    same) and a low-variance one (100 or 101): within 1e-5 of the largest
    sum, the per-channel sums bit for bit."""
    from vacv_tpu_torch.ops.cuda.window_sum import window_sums, window_sums_torch

    if kind == "flat":
        x = torch.full((3, 720, 1280), 50.0, device=cuda)
    else:
        x = rand_on(cuda, (3, 720, 1280), seed=19, lo=100, hi=102)
    if layout == "hwc":
        x = x.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    sq, sums = window_sums(x, 48, 48, sq=True, sums=True)
    want_sq, want_sums = window_sums_torch(x, 48, 48, sq=True, sums=True)
    assert (sq - want_sq).abs().max().item() <= 1e-5 * want_sq.abs().max().item()
    assert torch.equal(sums, want_sums)


# ---- the config-5 tail: the fused kernel on planar u8 planes --------------

@pytest.mark.parametrize("interp", ["linear", "cubic", "nearest"])
@pytest.mark.parametrize("stats", list(C4_STATS) + ["static", "raw"])
@pytest.mark.parametrize("n,h,w,out", [(2, 171, 304, (96, 96)), (3, 37, 53, (61, 29)),
                                       (1, 684, 1216, (224, 224)), (2, 64, 112, (112, 64))])
def test_planar_kernel_matches_plain_version(cuda, interp, stats, n, h, w, out):
    """preprocess_fused_planes on (N, 3, h, w) u8 planes: the
    ``normalize=False`` planes bit for bit or, where cuBLAS sums the plain
    version's dense products in another order, 1 LSB apart on under 1e-3
    of the values, each on the truncation boundary in float64; the
    normalized output within cosine 1-1e-6 of the plain version and, with a
    self statistic, bit for bit its integer statistics over those planes;
    one launch a call."""
    from vacv_tpu_torch.ops.cuda.preprocess import (
        INTERP_MODES, _resize_weights, one_pass_stats, preprocess_fused_planes,
        preprocess_fused_planes_torch,
    )
    from vacv_tpu_torch.ops.resize import u8_eps

    kw = dict(C4_STATS.get(stats, {}))
    if stats == "static":
        kw = dict(mean=(104.0, 117.0, 123.0), stddev=(57.1, 57.4, 58.4))
    if stats == "raw":
        kw = dict(normalize=False)
    planes = batch_on(cuda, n=n, h=h, w=w, seed=h + out[0]).permute(0, 3, 1, 2).contiguous()
    raw = preprocess_fused_planes(planes, out, interp=interp, normalize=False)
    plain = preprocess_fused_planes_torch(planes, out, interp=interp, normalize=False)
    flips = (raw - plain).abs() > 0
    assert (raw - plain).abs().max().item() <= 1 and flips.double().mean().item() < 1e-3
    if flips.any():
        wy, wx = (torch.from_numpy(_resize_weights(a, b, interp)).to(cuda, torch.float64)
                  for a, b in ((h, out[1]), (w, out[0])))
        edge = torch.matmul(torch.matmul(wy, planes.double()), wx.T)[flips]
        edge = edge + u8_eps(INTERP_MODES[interp])
        assert (edge - edge.round()).abs().max().item() < 1e-4
    before = config.kernel_count("preprocess_fused_planar")
    got = preprocess_fused_planes(planes, out, interp=interp, **kw)
    torch.cuda.synchronize()
    assert config.kernel_count("preprocess_fused_planar") == before + 1
    want = preprocess_fused_planes_torch(planes, out, interp=interp, **kw)
    assert got.shape == want.shape == (n, 3, out[1], out[0])
    if stats == "raw":
        assert torch.equal(got, raw)
    else:
        assert cosine(got, want) >= 1 - 1e-6 and (got - want).abs().max().item() < 0.05
    if stats in C4_STATS:
        mu, inv = one_pass_stats(raw, kw.get("mean"), kw.get("stddev"))
        assert torch.equal(got, (raw - mu[..., None, None]) * inv[..., None, None])


def test_planar_kernel_raises_on_inputs_it_does_not_take(cuda):
    from vacv_tpu_torch.ops.cuda.preprocess import preprocess_fused_planes

    planes = batch_on(cuda, n=2, h=40, w=60).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        preprocess_fused_planes(planes, (16, 16))
    with pytest.raises(ValueError, match="uint8"):
        preprocess_fused_planes(planes.float().contiguous(), (16, 16))


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "i8"])
@pytest.mark.parametrize("m,k16,k8,n,reps", [
    (96, 128, 128, 2048, 64),   # four blocks a tile
    (96, 128, 128, 1024, 67),   # eight, reps not a multiple of the split
    (96, 128, 128, 2048, 1),    # one rep: no split
    (1, 32, 32, 8, 64),         # one row, one tile: sixteen blocks
    (17, 96, 96, 9, 24),
    (130, 160, 192, 200, 7),    # ragged M, N and K
])
def test_probe_kernel_split_and_edge_shapes(cuda, dtype, m, k16, k8, n, reps):
    """The split path (the reps of a tile over several blocks, summed in a
    second launch), tile edges in M, N and K: bit-exact and the same on
    every run."""
    k = k16 if dtype == torch.bfloat16 else k8
    g = torch.Generator(device=cuda)
    g.manual_seed(m * 7 + k + n + reps)
    a = torch.randint(-100, 100, (m + reps, k), generator=g, device=cuda).to(dtype)
    b = torch.randint(-2, 3, (k, n), generator=g, device=cuda).to(dtype)
    got = probe_dot(a, b, reps)
    assert torch.equal(got, probe_dot_torch(a, b, reps))
    assert torch.equal(probe_dot(a, b, reps), got)


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


# --- the tracer's counters and spans on the card (utils/trace.py) --------


def _config5(frame_w=2560, frame_h=1440):
    """BASELINE config 5's Preprocessor on the card (portbench's config)."""
    return Preprocessor(PreprocessConfig(
        crop_rect=VRect(64, 36, frame_w - 64, frame_h - 36),
        warp=(((0.9, 0.03, 40.0), (-0.03, 0.9, 25.0)), (1216, 684)), out_size=(224, 224)),
        device="cuda")


@pytest.mark.parametrize("which,calls", [("config4", 1), ("config5", 1)])
def test_a_batch_makes_its_calls_into_the_kernel_library(cuda, which, calls):
    from vacv_tpu_torch.utils import trace

    if which == "config4":
        pre = Preprocessor(PreprocessConfig(crop_rect=VRect(64, 28, 1856, 1064),
                                            out_size=(224, 224)), device="cuda")
        batch = batch_on(cuda, n=8, h=1080, w=1920)
    else:
        pre, batch = _config5(), batch_on(cuda, n=2, h=1440, w=2560)
    top = torch.tensor(5, dtype=torch.int32, device=cuda)
    pre.batch(batch, top=top)  # tables and plans made
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    trace.keep_events(True)
    try:
        before, made = trace.counter("native.calls"), trace.counter("tables.made")
        pre.batch(batch, top=top)
        torch.cuda.synchronize()
        assert trace.counter("native.calls") - before == calls
        assert trace.counter("tables.made") == made
        events = trace.snapshot()["events"]
    finally:
        trace.disable()
        trace.keep_events(False)
        trace.reset()
    native = [e for e in events if e["name"] == "native.call"]
    assert len(native) == calls and all(e["parent"].startswith("ops.") for e in native)
    assert events[-1]["name"] == "pipeline.batch"


def test_a_served_frame_is_staged_and_sent_once(cuda):
    from vacv_tpu_torch.models import StreamExecutor
    from vacv_tpu_torch.utils import trace

    pre = Preprocessor(PreprocessConfig(crop_rect=VRect(64, 28, 1856, 1064),
                                        out_size=(224, 224)), device="cuda")
    frame = np.random.default_rng(3).integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    ex = StreamExecutor(pre, depth=2)
    trace.reset()
    trace.enable()
    try:
        sent = trace.counter("serve.h2d_bytes")
        assert ex.submit(frame) is None
        assert trace.counter("serve.h2d_bytes") - sent == 6_220_800
        spans = trace.snapshot()["spans"]
        (out,) = ex.drain()
        torch.cuda.synchronize()
    finally:
        trace.disable()
        trace.reset()
    for name in ("serve.submit", "serve.slot_wait", "serve.stage", "serve.h2d",
                 "pipeline.batch", "native.call"):
        assert spans[name]["count"] == 1, name
    assert out.shape == (3, 224, 224)


# --- launch records (models/pipeline.py: a batch's launch prepared once) ----

RECORD_ROUTES = {
    "cuda_fused": (PreprocessConfig(crop_rect=RECT, out_size=OUT),
                   lambda dev, seed: batch_on(dev, n=4, seed=seed)),
    "cuda_fused_nv": (PreprocessConfig(color_code=ColorCode.COLOR_YUV2BGR_NV21, crop_rect=NV_RECT,
                                       out_size=OUT),
                      lambda dev, seed: nv_on(dev, n=3, seed=seed)),
    "cuda_warp": (PreprocessConfig(crop_rect=VRect(20, 10, 620, 350),
                                   warp=(tuple(map(tuple, M_ROT)), (304, 171)), out_size=(96, 96)),
                  lambda dev, seed: batch_on(dev, n=3, seed=seed)),
}
RECORD_TOPS = [3, 0, 41, -7, 400]  # inside, at the edge, clamped below and above


def through_the_wrappers(pre, batch, top):
    """The route's calls of the public wrappers, which prepare every call."""
    if pre._warp_route():
        return pre._run_warp(batch, top)
    return pre._run_fused(batch, pre._fused_geometry(tuple(batch.shape[1:]), batch.dtype), top)


def record_counts():
    from vacv_tpu_torch.utils import trace

    return trace.counter("pipeline.records_made"), trace.counter("pipeline.record_hits")


@pytest.mark.parametrize("top", ["none", "int", "tensor"])
@pytest.mark.parametrize("route", list(RECORD_ROUTES))
def test_a_record_hit_a_miss_and_the_wrappers_give_the_same_bits(cuda, route, top):
    """Five batches of new data, the top changing every call: the hits,
    a new Preprocessor's miss and the public wrappers agree bit for bit,
    and no call changes an earlier call's output."""
    cfg, make = RECORD_ROUTES[route]
    pre = Preprocessor(cfg, device="cuda")
    made, hits = record_counts()
    kept = []
    for k, t in enumerate(RECORD_TOPS):
        batch = make(cuda, k)
        assert pre.describe_route(batch.shape[1:]) == route
        t = {"none": None, "int": t, "tensor": torch.tensor(t, dtype=torch.int32, device=cuda)}[top]
        got = pre.batch(batch, top=t)
        miss = Preprocessor(cfg, device="cuda").batch(batch, top=t)
        want = through_the_wrappers(pre, batch, t)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(miss, want), (route, top, k)
        kept.append((got, got.clone()))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in kept)
    n = len(RECORD_TOPS)
    assert tuple(c - b for c, b in zip(record_counts(), (made, hits))) == (1 + n, n - 1)


def test_an_int64_top_on_the_host_is_cast_as_before(cuda):
    for route, (cfg, make) in RECORD_ROUTES.items():
        pre = Preprocessor(cfg, device="cuda")
        batch = make(cuda, 9)
        for t in (5, 33):
            top = torch.tensor([t])  # int64, on the host
            got = pre.batch(batch, top=top)
            want = through_the_wrappers(pre, batch, top)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (route, t)


@pytest.mark.parametrize("route", list(RECORD_ROUTES))
def test_records_on_four_lane_streams(cuda, route):
    """``StreamExecutor``'s four lanes: a record a lane's stream, made
    once, and every frame's bits as one stream's."""
    from vacv_tpu_torch.models import StreamExecutor

    cfg, make = RECORD_ROUTES[route]
    pre = Preprocessor(cfg, device="cuda")
    frames = [f for k in range(4) for f in make(cuda, 20 + k)]
    made, hits = record_counts()
    ex = StreamExecutor(pre, depth=4)
    got = [o for o in (ex.submit(f) for f in frames) if o is not None] + list(ex.drain())
    torch.cuda.synchronize()
    assert tuple(c - b for c, b in zip(record_counts(), (made, hits))) == (4, len(frames) - 4)
    one = Preprocessor(cfg, device="cuda")
    for k, (f, o) in enumerate(zip(frames, got)):
        assert torch.equal(o, through_the_wrappers(one, f[None], None)[0]), (route, k)


def test_two_preprocessors_alternating_keep_their_own_records(cuda):
    """Two Preprocessors of one route and one of another on one stream, in
    turns: each output as the wrappers give it."""
    (c4, make4), (c5, make5) = RECORD_ROUTES["cuda_fused"], RECORD_ROUTES["cuda_warp"]
    pres = [Preprocessor(c4, device="cuda"), Preprocessor(c5, device="cuda"),
            Preprocessor(dataclasses.replace(c4, out_size=(64, 80)), device="cuda")]
    made, _ = record_counts()
    outs = []
    for k in range(9):
        pre = pres[k % 3]
        batch = (make5 if pre._warp_route() else make4)(cuda, k)
        top = torch.tensor(k * 5, dtype=torch.int32, device=cuda)
        outs.append((pre.batch(batch, top=top), through_the_wrappers(pre, batch, top)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in outs)
    assert record_counts()[0] - made == 3
