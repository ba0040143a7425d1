"""The fused warp on the card: ``pytest -m gpu tests/test_torch_warp_fused.py``.

``prepare_fused_warp`` (``csrc/preprocess_warp.cu``) samples the affine
warp inside kernel #1's moments form, only where the resize reads it.  Each
test holds its output to the two-launch chain it replaces, the warp
(``warp_planes_batch``) into planes, then the planar tail
(``preprocess_fused_planes``), bit for bit (``torch.equal``): at config 5's
geometry at 1, 2 and 16 frames, with the crop top as None, an int, a device
int32, an int64 tensor and out-of-range values (clamped), with linear,
cubic and nearest tails, a static mean, warp sizes that leave partial
tiles, maps whose output corners fall outside the source (the border rule,
border 0), and sources at every alignment.  The f32 output is the integer
moments' scale of the truncated planes, so equal outputs mean equal
statistics; one test also holds it to the host twin of those statistics.
The ``cuda`` fixture skips every test when PyTorch sees no CUDA device.
"""
import numpy as np
import pytest
import torch

from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import VRect
from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
from vacv_tpu_torch.ops.cuda.preprocess import (
    one_pass_stats, prepare_fused_warp, preprocess_fused_planes,
)
from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch
from vacv_tpu_torch.ops.warp_affine import invert_affine

pytestmark = pytest.mark.gpu

# BASELINE config 5: 2560x1440 frames, the crop (64, 36)-(2496, 1404), a
# rotated map to 1216x684, 224x224 out.
M5 = ((0.9, 0.03, 40.0), (-0.03, 0.9, 25.0))
RECT5 = VRect(64, 36, 2496, 1404)
MINV5 = invert_affine(np.asarray(M5, np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def frames_on(device, n, h=1440, w=2560, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=g, dtype=torch.uint8, device=device)


def two_launch(planes, minv, h_out, w_out, out_size, row0=None, rows=None, **kw):
    """The chain the fused warp replaces: the warp (constant border 0),
    then the planar tail."""
    warped = warp_planes_batch(planes, minv, h_out, w_out, row0=row0, rows=rows)
    return preprocess_fused_planes(warped, out_size, **kw)


def fused(planes, minv, h_out, w_out, out_size, row0=None, rows=None, **kw):
    """The fused warp's one call, counted once."""
    rec = prepare_fused_warp(planes, minv, h_out, w_out, out_size, row0=row0, rows=rows, **kw)
    assert rec is not None
    before = config.kernel_count("preprocess_fused_warp")
    out = rec.run(planes, row0)
    assert config.kernel_count("preprocess_fused_warp") == before + 1
    return out


@pytest.mark.parametrize("n", [1, 2, 16])
@pytest.mark.parametrize("top", [36, 0, 72, -5, 400], ids=lambda t: f"top{t}")
def test_config_5_device_top_is_the_two_launch_chain(cuda, n, top):
    """Config 5's geometry, the crop top on the device (inside, at both
    ends, and clamped from below and above), bit for bit."""
    batch = frames_on(cuda, n, seed=n)
    planes = batch.narrow(2, 64, 2432).permute(0, 3, 1, 2)
    t = torch.tensor(top, dtype=torch.int32, device=cuda)
    got = fused(planes, MINV5, 684, 1216, (224, 224), row0=t, rows=1368)
    want = two_launch(planes, MINV5, 684, 1216, (224, 224), row0=t, rows=1368)
    assert torch.equal(got, want)


@pytest.mark.parametrize("interp", ["linear", "cubic", "nearest"])
def test_config_5_tails_and_their_statistics(cuda, interp):
    """Every tail the moments form takes, a static crop: bit for bit the
    chain, and the host twin of the integer statistics over the chain's
    truncated planes."""
    batch = frames_on(cuda, 2, seed=7)
    planes = batch[:, 36:1404, 64:2496].permute(0, 3, 1, 2)
    got = fused(planes, MINV5, 684, 1216, (224, 224), interp=interp)
    assert torch.equal(got, two_launch(planes, MINV5, 684, 1216, (224, 224), interp=interp))
    warped = warp_planes_batch(planes, MINV5, 684, 1216)
    raw = preprocess_fused_planes(warped, (224, 224), interp=interp, normalize=False)
    mu, inv = one_pass_stats(raw)
    assert torch.equal(got, (raw - mu[..., None, None]) * inv[..., None, None])


def test_config_5_static_mean(cuda):
    batch = frames_on(cuda, 2, seed=8)
    planes = batch[:, 36:1404, 64:2496].permute(0, 3, 1, 2)
    kw = dict(mean=(104.0, 117.0, 123.0))
    got = fused(planes, MINV5, 684, 1216, (224, 224), **kw)
    assert torch.equal(got, two_launch(planes, MINV5, 684, 1216, (224, 224), **kw))


@pytest.mark.parametrize("size,out", [((677, 1213), (224, 224)), ((171, 304), (96, 96)),
                                      ((37, 53), (61, 29)), ((1, 1), (4, 4))],
                         ids=["partial_tiles", "small", "odd", "one_pixel"])
def test_warp_sizes_with_partial_tiles(cuda, size, out):
    batch = frames_on(cuda, 3, h=360, w=640, seed=9)
    planes = batch[:, 10:350, 20:620].permute(0, 3, 1, 2)
    minv = invert_affine(np.asarray(((0.5, 0.02, 3.0), (-0.02, 0.5, 1.5)), np.float32))
    got = fused(planes, minv, *size, out)
    assert torch.equal(got, two_launch(planes, minv, *size, out))


# Maps whose output corners fall outside the source: a zoom-out, a steep
# rotation, a flip and a shift past the far edge.
OUTSIDE = {
    "zoom_out": ((0.3, 0.0, 60.0), (0.0, 0.3, 40.0)),
    "rotation": ((0.6, 0.8, -100.0), (-0.8, 0.6, 300.0)),
    "flip": ((-1.0, 0.0, 500.0), (0.0, 1.0, -20.0)),
    "far_shift": ((1.0, 0.0, -450.0), (0.0, 1.0, -250.0)),
}


@pytest.mark.parametrize("matrix", list(OUTSIDE))
def test_maps_past_the_source_take_the_border_rule(cuda, matrix):
    batch = frames_on(cuda, 2, h=360, w=640, seed=10)
    planes = batch[:, 20:340, 30:610].permute(0, 3, 1, 2)
    minv = invert_affine(np.asarray(OUTSIDE[matrix], np.float32))
    got = fused(planes, minv, 300, 400, (112, 96))
    want = two_launch(planes, minv, 300, 400, (112, 96))
    assert torch.equal(got, want)


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("left", [64, 63])
def test_any_alignment(cuda, base, left):
    """A source at every byte offset of a word: the taps' addresses carry
    no alignment."""
    raw = frames_on(cuda, 2, h=720, w=1281, seed=11).reshape(-1)
    batch = raw[base:base + 2 * 720 * 1280 * 3].reshape(2, 720, 1280, 3)
    planes = batch[:, 18:702, left:left + 1216].permute(0, 3, 1, 2)
    minv = invert_affine(np.asarray(M5, np.float32))
    got = fused(planes, minv, 342, 608, (224, 224))
    assert torch.equal(got, two_launch(planes, minv, 342, 608, (224, 224)))


def config5():
    return Preprocessor(PreprocessConfig(crop_rect=RECT5, warp=(M5, (1216, 684)),
                                         out_size=(224, 224)), device="cuda")


@pytest.mark.parametrize("top", ["none", "int", "int_clamped", "int32", "int64", "int32_clamped"])
@pytest.mark.parametrize("n", [1, 2, 16])
def test_the_config_5_record_takes_the_fused_warp(cuda, n, top):
    """``Preprocessor.batch`` at config 5: one ``preprocess_fused_warp``
    call a batch, no warp launch, no ``warp.hwc3_launches``, and the bits
    of the public wrappers' two-launch chain, for every kind of top."""
    from vacv_tpu_torch.utils import trace

    pre = config5()
    batch = frames_on(cuda, n, seed=20 + n)
    t = {"none": None, "int": 30, "int_clamped": 500,
         "int32": torch.tensor(12, dtype=torch.int32, device=cuda),
         "int64": torch.tensor([40]),
         "int32_clamped": torch.tensor(-9, dtype=torch.int32, device=cuda)}[top]
    names = ("preprocess_fused_warp", "warp_affine", "preprocess_fused_planar")
    before = [config.kernel_count(k) for k in names]
    hwc3 = trace.counter("warp.hwc3_launches")
    outs = [pre.batch(batch, top=t) for _ in range(2)]  # a record made, then a hit
    assert [config.kernel_count(k) - b for k, b in zip(names, before)] == [2, 0, 0]
    assert trace.counter("warp.hwc3_launches") == hwc3
    want = pre._run_warp(batch, t)
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
