"""BASELINE config 5's tail on the planar route: the fused kernel's plain
version over the warped batch, against vacv_tpu's Preprocessor.

A warp config whose warped planes are three u8 planes, with an output size,
CHW output and a linear, cubic or nearest resize, runs its tail as one
``preprocess_fused_planes`` call over the whole batch (the plain version
``preprocess_fused_planes_torch`` on a CPU tensor); every other tail keeps
the per-frame chain.  The same seeded numpy frames go through the JAX
Preprocessor (its ``jnp`` chain and its ``pallas`` route, which folds the
batch into one warp call) and through the port.  The planar route resizes
vertical pass first where the chain takes the cheaper pass order, so a
value on the u8 truncation boundary may come out one LSB apart: bars are
u8 within 1 LSB on under 1e-3 of the values (``normalize=False``) and
normalized output at cosine ≥ 1−1e-4 with max-abs < 0.05.
"""
import numpy as np
import pytest
import torch

import vacv_tpu as vc
from vacv_tpu import config as jconfig
from vacv_tpu.models import PreprocessConfig as JConfig
from vacv_tpu.models import Preprocessor as JPre
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import ColorCode, InterMode, Layout, VRect
from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
from vacv_tpu_torch.ops.cuda import preprocess as pk
from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch
from vacv_tpu_torch.ops.warp_affine import invert_affine


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


M5 = ((0.9, 0.03, 4.0), (-0.03, 0.9, 2.5))  # config 5's rotation and scale
RECT5 = (6, 4, 250, 140)
DSIZE = (112, 64)
BASE = dict(crop_rect=RECT5, warp=(M5, DSIZE), out_size=(32, 32))
STATIC = dict(mean=(104.0, 117.0, 123.0), stddev=(57.1, 57.4, 58.4))
STATS = {
    "self": {},
    "static mean, self stddev": dict(mean=STATIC["mean"]),
    "self mean, static stddev": dict(stddev=STATIC["stddev"]),
    "static": STATIC,
    "normalize=False": dict(normalize=False),
}
INTERPS = {"linear": InterMode.INTER_LINEAR, "cubic": InterMode.INTER_CUBIC,
           "nearest": InterMode.INTER_NEAREST}


def frames(seed, n=2, h=144, w=256):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def configs(**fields):
    """(port config, JAX config) from one dict of field values."""
    port, jax_ = dict(fields), dict(fields)
    if "crop_rect" in fields:
        port["crop_rect"] = VRect(*fields["crop_rect"])
        jax_["crop_rect"] = vc.VRect(*fields["crop_rect"])
    if "interpolation" in fields:
        jax_["interpolation"] = vc.InterMode(int(fields["interpolation"]))
    if "color_code" in fields:
        jax_["color_code"] = vc.ColorCode(int(fields["color_code"]))
    if "out_layout" in fields:
        jax_["out_layout"] = vc.Layout(fields["out_layout"].value)
    return PreprocessConfig(**port), JConfig(**jax_)


def jax_batch(jcfg, batch, backend):
    with jconfig.backend(backend):
        return np.asarray(JPre(jcfg).batch(batch))


def assert_tail_close(got, want, normalized):
    """The planar route's bars against the JAX chain (module docstring)."""
    assert got.shape == want.shape and got.dtype == np.float32
    diff = np.abs(got.astype(np.float64) - want)
    if normalized:
        assert 1 - cosine_similarity(got, want) <= 1e-4
        assert diff.max() < 0.05
    else:
        flips = int(np.count_nonzero(diff))
        assert diff.max() <= 1.0 and flips <= 1e-3 * diff.size, f"{flips} flips, max {diff.max()}"


def planar_calls(run):
    """(planar tail calls, per-frame normalize calls) that ``run()`` made."""
    names = ("preprocess_fused_planar_torch", "normalize_fused_torch")
    before = [config.kernel_count(k) for k in names]
    out = run()
    return out, [config.kernel_count(k) - b for k, b in zip(names, before)]


@pytest.mark.parametrize("stats", list(STATS))
@pytest.mark.parametrize("interp", list(INTERPS))
def test_planar_tail_matches_jax_jnp(interp, stats):
    """Every interpolation and statistics mode: ``Preprocessor.batch`` on
    the planar route, and the plain version on the port's warped planes,
    against the JAX chain."""
    cfg, jc = configs(**BASE, interpolation=INTERPS[interp], **STATS[stats])
    batch = frames(30)
    want = jax_batch(jc, batch, "jnp")
    got, calls = planar_calls(lambda: Preprocessor(cfg).batch(batch).numpy())
    assert calls == [1, 0]
    assert_tail_close(got, want, cfg.normalize)
    # The plain version on the port's own warped planes gives the same.
    left, top, right, bottom = RECT5
    planes = torch.from_numpy(batch).permute(0, 3, 1, 2)[:, :, top:bottom, left:right]
    warped = warp_planes_batch(planes, invert_affine(np.asarray(M5, np.float32)), DSIZE[1],
                               DSIZE[0])
    direct = pk.preprocess_fused_planes_torch(warped, (32, 32), interp=interp,
                                              normalize=cfg.normalize, mean=cfg.mean,
                                              stddev=cfg.stddev)
    np.testing.assert_array_equal(direct.numpy(), got)


@pytest.mark.parametrize("stats", ["self", "static", "normalize=False"])
def test_planar_tail_matches_jax_pallas(stats):
    """The JAX package's pallas route (the batch folded into one warp
    kernel call in interpret mode, then its vmapped tail)."""
    cfg, jc = configs(**BASE, **STATS[stats])
    batch = frames(31)
    want = jax_batch(jc, batch, "pallas")
    got, calls = planar_calls(lambda: Preprocessor(cfg).batch(batch).numpy())
    assert calls == [1, 0]
    assert_tail_close(got, want, cfg.normalize)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_planar_tail_batches(n, interp):
    """Batches of 1, 2 and 3 frames: one planar call a batch, each frame
    as the JAX chain gives it, and as the frame alone gives it."""
    cfg, jc = configs(**BASE, interpolation=INTERPS[interp])
    batch = frames(32 + n, n=n)
    want = jax_batch(jc, batch, "jnp")
    pre = Preprocessor(cfg)
    got, calls = planar_calls(lambda: pre.batch(batch).numpy())
    assert calls == [1, 0] and got.shape == (n, 3, 32, 32)
    assert_tail_close(got, want, True)
    for i in range(n):
        np.testing.assert_array_equal(pre(batch[i]).numpy(), got[i])


@pytest.mark.parametrize("interp", list(INTERPS))
@pytest.mark.parametrize("stats", ["self", "normalize=False"])
def test_planar_tail_at_the_warps_own_size(interp, stats):
    """``out_size`` equal to the warp's dsize: the resize is the identity
    (the chain's same-size shortcut, the kernel's one-tap tables), so the
    u8 planes are the port's own chain's bit for bit; against the JAX
    chain they keep the bar (the warps themselves may differ by one LSB)."""
    cfg, jc = configs(**dict(BASE, out_size=DSIZE), interpolation=INTERPS[interp],
                      **STATS[stats])
    batch = frames(36)
    want = jax_batch(jc, batch, "jnp")
    pre = Preprocessor(cfg)
    got, calls = planar_calls(lambda: pre.batch(batch).numpy())
    assert calls == [1, 0] and got.shape == (2, 3, DSIZE[1], DSIZE[0])
    assert_tail_close(got, want, cfg.normalize)
    if not cfg.normalize:
        with config.backend("torch"):
            np.testing.assert_array_equal(got, pre.batch(batch).numpy())


@pytest.mark.parametrize("top", [1, 8, 0, -3, 30])
def test_planar_tail_runtime_top(top, monkeypatch):
    """``batch(top=...)`` moves the crop before the warp on the planar
    route: equal to a JAX Preprocessor built with the moved rect (the top
    clamped to the frame, a negative one to 0), for an int and a tensor
    top.  A tensor top goes to the warp with the uncut frames: one warp
    call, and no ``dynamic_slice`` on that route."""
    import vacv_tpu_torch.models.pipeline as pipeline

    cfg, _ = configs(**BASE)
    clamped = min(max(top, 0), 144 - 136)
    _, moved = configs(**dict(BASE, crop_rect=(RECT5[0], clamped, RECT5[2], clamped + 136)))
    batch = frames(37)
    want = jax_batch(moved, batch, "jnp")
    pre = Preprocessor(cfg)
    for t in (top, torch.tensor(top, dtype=torch.int32)):
        if isinstance(t, torch.Tensor):
            def no_gather(*args, **kwargs):
                raise AssertionError("dynamic_slice on the device-top route")
            monkeypatch.setattr(pipeline, "dynamic_slice", no_gather)
        w0 = config.kernel_count("warp_affine_torch")
        got, calls = planar_calls(lambda: pre.batch(batch, top=t).numpy())
        assert calls == [1, 0] and config.kernel_count("warp_affine_torch") == w0 + 1
        assert_tail_close(got, want, True)


TAILS = {
    # name: (config fields, frames dtype, takes the planar call)
    "u8 linear CHW": (dict(BASE), np.uint8, True),
    "u8 nearest, no crop": (dict(warp=(M5, DSIZE), out_size=(32, 32),
                                 interpolation=InterMode.INTER_NEAREST), np.uint8, True),
    "NV21 input": (dict(BASE, color_code=ColorCode.COLOR_YUV2BGR_NV21), "nv21", True),
    "f32 frames": (dict(BASE), np.float32, False),
    "gray": (dict(BASE, color_code=ColorCode.COLOR_BGR2GRAY), np.uint8, False),
    "HWC out": (dict(BASE, out_layout=Layout.HWC), np.uint8, False),
    "area": (dict(BASE, interpolation=InterMode.INTER_AREA), np.uint8, False),
    "lanczos": (dict(BASE, interpolation=InterMode.INTER_LANCZOS4), np.uint8, False),
    "no out_size": (dict(crop_rect=RECT5, warp=(M5, (48, 40))), np.uint8, False),
}


@pytest.mark.parametrize("name", list(TAILS))
def test_which_tails_take_the_planar_call(name):
    """The route table: three u8 planes, an output size, CHW out and a
    linear, cubic or nearest resize take one planar call a batch; f32
    frames, gray, HWC out, area, Lanczos and no output size keep the
    per-frame tail.  Each matches the JAX chain either way."""
    fields, kind, planar = TAILS[name]
    cfg, jc = configs(**fields)
    if kind == "nv21":
        batch = np.random.default_rng(38).integers(0, 256, (2, 216, 256), dtype=np.uint8)
    else:
        batch = frames(38).astype(kind)
    want = jax_batch(jc, batch, "jnp")
    pre = Preprocessor(cfg)
    assert pre.describe_route(batch.shape[1:], batch.dtype) == "warp_torch"
    got, calls = planar_calls(lambda: pre.batch(batch).numpy())
    assert calls[0] == int(planar)
    if planar:
        assert_tail_close(got, want, True)
    else:
        assert got.shape == want.shape
        assert 1 - cosine_similarity(got, want) <= 1e-6 and np.abs(got - want).max() < 0.05


def test_planar_wrapper_checks_and_counts():
    """What the wrapper refuses, and its counter on the CPU."""
    planes = torch.zeros((2, 3, 20, 30), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        pk.preprocess_fused_planes(planes.float(), (8, 8))
    with pytest.raises(ValueError, match="uint8"):
        pk.preprocess_fused_planes(planes[:, :2], (8, 8))
    with pytest.raises(ValueError, match="interp"):
        pk.preprocess_fused_planes(planes, (8, 8), interp="area")
    with pytest.raises(ValueError, match="empty output"):
        pk.preprocess_fused_planes(planes, (0, 8))
    k0, p0 = (config.kernel_count("preprocess_fused_planar"),
              config.kernel_count("preprocess_fused_planar_torch"))
    out = pk.preprocess_fused_planes(planes, (8, 6), normalize=False)
    assert out.shape == (2, 3, 6, 8) and out.dtype == torch.float32
    assert config.kernel_count("preprocess_fused_planar_torch") == p0 + 1
    assert config.kernel_count("preprocess_fused_planar") == k0  # no card here


H100 = pk.CardLimits(sms=132, threads_per_sm=2048, smem_bytes=232448 - 128, smem_per_sm=233472)


@pytest.mark.parametrize("n", [1, 2, 8, 128])
def test_planar_launch_plan(n):
    """The planar source takes the BGR forms: the moments form for self
    statistics with truncation, one resize launch for static statistics
    or ``normalize=False``."""
    assert pk.launch_plan(n, 224, 224, H100, source="planar").form == "moments"
    assert pk.launch_plan(n, 224, 224, H100, source="planar", self_stats=False).form \
        == "resize_only"
    assert pk.launch_plan(n, 224, 224, H100, source="planar", normalize=False).form \
        == "resize_only"
    assert pk.launch_plan(n, 224, 224, H100, source="planar") \
        == pk.launch_plan(n, 224, 224, H100, source="bgr")
    # A frame past 2^32 / 255 pixels cannot take the exact integer moments.
    assert pk.launch_plan(n, 5000, 4000, H100, source="planar").form == "two_launch"

