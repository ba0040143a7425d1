"""The whole slice: vacv_tpu_torch's Preprocessor against vacv_tpu's.

The same numpy frames go through the JAX Preprocessor, under its
``pallas`` backend (the fused kernel in interpret mode, exact path) and
its ``jnp`` backend (the XLA chain), and through the port's, on its
fused route (the kernel's plain version on a CPU tensor) and on its
``torch`` chain.  Bars: cosine >= 1-1e-6 and max-abs < 0.05.
"""
import dataclasses

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


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


H, W = 360, 640
RECT = (17, 20, 617, 340)


def frames(seed, n=2, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def jcfg(cfg: PreprocessConfig) -> JConfig:
    """The JAX package's config for a port config (same field values)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.crop_rect is not None:
        kw["crop_rect"] = vc.VRect(*dataclasses.astuple(cfg.crop_rect))
    kw["interpolation"] = vc.InterMode(int(cfg.interpolation))
    kw["out_layout"] = vc.Layout(cfg.out_layout.value)
    return JConfig(**kw)


def jax_batch(cfg, batch, backend):
    with jconfig.backend(backend):
        return np.asarray(JPre(jcfg(cfg)).batch(batch))


def assert_close(got, want):
    assert got.shape == want.shape
    assert abs(cosine_similarity(got, want) - 1) < 1e-6
    assert np.max(np.abs(got - want)) < 0.05


CONFIGS = {
    "config4": PreprocessConfig(crop_rect=VRect(*RECT), out_size=(112, 96)),
    "cubic": PreprocessConfig(crop_rect=VRect(*RECT), out_size=(112, 96),
                              interpolation=InterMode.INTER_CUBIC),
    "nearest_static": PreprocessConfig(out_size=(128, 72), interpolation=InterMode.INTER_NEAREST,
                                       mean=(104.0, 117.0, 123.0), stddev=(57.1, 57.4, 58.4)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("jax_backend", ["pallas", "jnp"])
@pytest.mark.parametrize("port_backend", ["auto", "torch"])
def test_batch_matches_jax_preprocessor(name, jax_backend, port_backend):
    cfg = CONFIGS[name]
    batch = frames(0)
    want = jax_batch(cfg, batch, jax_backend)
    pre = Preprocessor(cfg)
    with config.backend(port_backend):
        route = pre.describe_route(batch.shape[1:])
        got = pre.batch(batch).numpy()
    assert route == ("fused_torch" if port_backend == "auto" else "torch_chain")
    assert_close(got, want)


def test_call_single_frame_matches():
    cfg = CONFIGS["config4"]
    frame = frames(1, n=1)[0]
    with jconfig.backend("jnp"):
        want = np.asarray(JPre(jcfg(cfg))(frame))
    got = Preprocessor(cfg)(frame)
    assert got.shape == (3, 96, 112) and got.dtype == torch.float32
    assert_close(got.numpy(), want)


def test_chain_routes_match_jax():
    """Configs the fused route does not take run the chain on both sides."""
    for cfg in (
        PreprocessConfig(crop_rect=VRect(*RECT), out_size=(112, 96),
                         interpolation=InterMode.INTER_AREA),
        PreprocessConfig(crop_rect=VRect(*RECT), out_size=(112, 96), out_layout=Layout.HWC),
        PreprocessConfig(crop_rect=VRect(*RECT), normalize=False),
    ):
        pre = Preprocessor(cfg)
        assert pre.describe_route((H, W, 3)) == "torch_chain"
        batch = frames(2, n=1)
        want = jax_batch(cfg, batch, "jnp")
        got = pre.batch(batch).numpy()
        if cfg.normalize:
            assert_close(got, want)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_runtime_top_matches_moved_rect(backend):
    """batch(top=...) moves the crop at run time (tracking camera); it
    equals a JAX Preprocessor built with the moved rect."""
    cfg = CONFIGS["config4"]
    batch = frames(3)
    moved = dataclasses.replace(cfg, crop_rect=VRect(RECT[0], 5, RECT[2], 5 + 320))
    want = jax_batch(moved, batch, "jnp")
    pre = Preprocessor(cfg)
    with config.backend(backend):
        for top in (5, torch.tensor(5, dtype=torch.int32)):
            assert_close(pre.batch(batch, top=top).numpy(), want)


def test_describe_route_and_counters():
    cfg = CONFIGS["config4"]
    assert Preprocessor(cfg).describe_route((H, W, 3)) == "fused_torch"
    # Describing a CUDA route needs no card.
    assert Preprocessor(cfg, device="cuda").describe_route((H, W, 3)) == "cuda_fused"
    assert Preprocessor(cfg).describe_route((H, W, 3), device="cuda") == "cuda_fused"
    assert Preprocessor(cfg).describe_route((H, W, 3), torch.float32) == "torch_chain"
    assert Preprocessor(cfg).describe_route((H, W, 4)) == "torch_chain"
    # A crop that leaves the frame takes the chain.
    assert Preprocessor(cfg).describe_route((300, W, 3)) == "torch_chain"
    with config.backend("torch"):
        assert Preprocessor(cfg).describe_route((H, W, 3)) == "torch_chain"
    k0 = config.kernel_count("preprocess_fused")
    p0 = config.kernel_count("preprocess_fused_torch")
    Preprocessor(cfg).batch(frames(4, n=1))
    assert config.kernel_count("preprocess_fused_torch") == p0 + 1
    assert config.kernel_count("preprocess_fused") == k0  # no card here


def test_devices_are_explicit():
    """A numpy batch goes to the Preprocessor's device; a tensor stays
    where it lies."""
    cfg = CONFIGS["config4"]
    batch = frames(5, n=1)
    assert Preprocessor(cfg).batch(batch).device.type == "cpu"
    assert Preprocessor(cfg, device="meta").batch(torch.from_numpy(batch)).device.type == "cpu"


def test_unported_configs_raise():
    """Every colour code and warp configs are ported; only an integer that
    is no colour code (in neither package) raises."""
    Preprocessor(PreprocessConfig(color_code=ColorCode.COLOR_YUV2BGR_NV21, out_size=(224, 224)))
    Preprocessor(PreprocessConfig(warp=(((1, 0, 0), (0, 1, 0)), (64, 64))))
    Preprocessor(PreprocessConfig(color_code=ColorCode.COLOR_BGR2RGB, out_size=(224, 224)))
    with pytest.raises(ValueError):
        Preprocessor(PreprocessConfig(color_code=12, out_size=(224, 224)))
    with pytest.raises(ValueError):
        vc.cvt_color(np.zeros((4, 4, 3), np.uint8), 12)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_runtime_top_is_clamped_on_both_routes(backend):
    cfg = CONFIGS["config4"]
    batch = frames(6, n=1)
    pre = Preprocessor(cfg)
    with config.backend(backend):
        np.testing.assert_array_equal(pre.batch(batch, top=-9).numpy(),
                                      pre.batch(batch, top=0).numpy())
        np.testing.assert_array_equal(pre.batch(batch, top=torch.tensor(999)).numpy(),
                                      pre.batch(batch, top=H - 320).numpy())


# ---- the NV camera path: stacked (H*3//2, W) NV21/NV12 buffers ----------

NV_RECT = (33, 24, 33 + 512, 24 + 224)


def nv_frames(seed, n=2, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (n, h + (h + 1) // 2, w), dtype=np.uint8)


NV_CONFIGS = {
    "nv21": PreprocessConfig(color_code=ColorCode.COLOR_YUV2BGR_NV21,
                             crop_rect=VRect(*NV_RECT), out_size=(112, 96)),
    "nv12_rgb_static": PreprocessConfig(color_code=ColorCode.COLOR_YUV2RGB_NV12,
                                        crop_rect=VRect(*NV_RECT), out_size=(112, 96),
                                        mean=(104.0, 117.0, 123.0), stddev=(57.1, 57.4, 58.4)),
    "nv21_cubic": PreprocessConfig(color_code=ColorCode.COLOR_YUV2BGR_NV21,
                                   crop_rect=VRect(*NV_RECT), out_size=(112, 96),
                                   interpolation=InterMode.INTER_CUBIC),
    "nv12_bgra_odd_h": PreprocessConfig(color_code=ColorCode.COLOR_YUV2BGRA_NV12,
                                        crop_rect=VRect(10, 6, 270, 202), out_size=(96, 64)),
}
NV_SHAPES = {"nv12_bgra_odd_h": (215, 284)}
NV_FUSED = {"nv21", "nv12_rgb_static"}


@pytest.mark.parametrize("name", list(NV_CONFIGS))
@pytest.mark.parametrize("jax_backend", ["pallas", "jnp"])
@pytest.mark.parametrize("port_backend", ["auto", "torch"])
def test_nv_batch_matches_jax_preprocessor(name, jax_backend, port_backend):
    """The fused NV configs take the fused route on both sides under
    their fused backends; cubic, an alpha code and an odd Y height take
    the decode chain."""
    cfg = NV_CONFIGS[name]
    h, w = NV_SHAPES.get(name, (H, W))
    batch = nv_frames(7, n=2, h=h, w=w)
    want = jax_batch(cfg, batch, jax_backend)
    pre = Preprocessor(cfg)
    with config.backend(port_backend):
        route = pre.describe_route(batch.shape[1:])
        got = pre.batch(batch).numpy()
    fused = port_backend == "auto" and name in NV_FUSED
    assert route == ("fused_nv_torch" if fused else "torch_chain")
    assert_close(got, want)


def test_nv_call_single_frame_matches():
    cfg = NV_CONFIGS["nv21"]
    frame = nv_frames(8, n=1)[0]
    with jconfig.backend("jnp"):
        want = np.asarray(JPre(jcfg(cfg))(frame))
    got = Preprocessor(cfg)(frame)
    assert got.shape == (3, 96, 112) and got.dtype == torch.float32
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("top", [1, 37])
def test_nv_runtime_top_matches_moved_rect(backend, top):
    """batch(top=...) moves the crop on the NV routes too; it equals a
    JAX Preprocessor built with the moved rect."""
    cfg = NV_CONFIGS["nv21"]
    batch = nv_frames(9)
    moved = dataclasses.replace(cfg, crop_rect=VRect(NV_RECT[0], top, NV_RECT[2], top + 224))
    want = jax_batch(moved, batch, "jnp")
    pre = Preprocessor(cfg)
    with config.backend(backend):
        for t in (top, torch.tensor(top, dtype=torch.int32)):
            assert_close(pre.batch(batch, top=t).numpy(), want)


def test_nv_describe_route_and_counters():
    cfg = NV_CONFIGS["nv21"]
    shape = (H * 3 // 2, W)
    assert Preprocessor(cfg).describe_route(shape) == "fused_nv_torch"
    assert Preprocessor(cfg, device="cuda").describe_route(shape) == "cuda_fused_nv"
    assert Preprocessor(cfg).describe_route(shape, device="cuda") == "cuda_fused_nv"
    assert Preprocessor(cfg).describe_route((H * 3 // 2 + 1, W)) == "torch_chain"  # odd Y height
    assert Preprocessor(cfg).describe_route((H * 3 // 2, W, 3)) == "torch_chain"   # not NV
    assert Preprocessor(cfg).describe_route(shape, torch.float32) == "torch_chain"
    assert Preprocessor(cfg).describe_route((150, 640)) == "torch_chain"  # crop leaves the frame
    for name in ("nv21_cubic", "nv12_bgra_odd_h"):
        assert Preprocessor(NV_CONFIGS[name]).describe_route(shape) == "torch_chain"
    with config.backend("torch"):
        assert Preprocessor(cfg).describe_route(shape) == "torch_chain"
    names = ("preprocess_fused_nv", "preprocess_fused_nv_torch", "yuv2bgr", "yuv2bgr_torch",
             "normalize_fused", "normalize_fused_torch")
    before = {k: config.kernel_count(k) for k in names}

    def rose():
        return {k: config.kernel_count(k) - before[k] for k in names}

    Preprocessor(cfg).batch(nv_frames(10))
    assert rose() == dict.fromkeys(names, 0) | {"preprocess_fused_nv_torch": 1}
    # The cubic chain decodes and normalizes each frame through the
    # kernels' wrappers (their plain versions here: no card).
    Preprocessor(NV_CONFIGS["nv21_cubic"]).batch(nv_frames(11, n=3))
    assert rose() == dict.fromkeys(names, 0) | {
        "preprocess_fused_nv_torch": 1, "yuv2bgr_torch": 3, "normalize_fused_torch": 3}


# ---- BASELINE config 5 at reduced size: crop → rotated warp → resize → normalize

def config_pair(**fields):
    """(port config, JAX config) built from one dict of field values, so
    both packages get the same parameters."""
    jfields = dict(fields)
    if "crop_rect" in fields:
        jfields["crop_rect"] = vc.VRect(*fields["crop_rect"])
        fields["crop_rect"] = VRect(*fields["crop_rect"])
    if "interpolation" in fields:
        jfields["interpolation"] = vc.InterMode(int(fields["interpolation"]))
    if "color_code" in fields:
        jfields["color_code"] = vc.ColorCode(int(fields["color_code"]))
    if "out_layout" in fields:
        jfields["out_layout"] = vc.Layout(fields["out_layout"].value)
    return PreprocessConfig(**fields), JConfig(**jfields)


M5 = ((0.9, 0.03, 4.0), (-0.03, 0.9, 2.5))  # config 5's rotation and scale
CONFIG5 = dict(crop_rect=(6, 4, 250, 140), warp=(M5, (112, 64)), out_size=(32, 32))


def frames5(seed, n=2):
    return frames(seed, n=n, h=144, w=256)


def jax_pre_batch(jcfg_, batch, backend):
    with jconfig.backend(backend):
        return np.asarray(JPre(jcfg_).batch(batch))


@pytest.mark.parametrize("jax_backend", ["pallas", "jnp"])
@pytest.mark.parametrize("port_backend", ["auto", "torch"])
def test_config5_batch_matches_jax_preprocessor(jax_backend, port_backend):
    cfg, jc = config_pair(**CONFIG5)
    batch = frames5(12)
    want = jax_pre_batch(jc, batch, jax_backend)
    pre = Preprocessor(cfg)
    names = ("warp_affine_torch", "normalize_fused_torch")
    before = [config.kernel_count(k) for k in names]
    with config.backend(port_backend):
        route = pre.describe_route(batch.shape[1:])
        got = pre.batch(batch).numpy()
    rose = [config.kernel_count(k) - b for k, b in zip(names, before)]
    if port_backend == "auto":
        # One warp call for the whole batch, one normalize per frame.
        assert route == "warp_torch" and rose == [1, 2]
    else:
        assert route == "torch_chain" and rose == [0, 0]
    assert got.shape == (2, 3, 32, 32)
    assert_close(got, want)


@pytest.mark.parametrize("fields", [
    dict(CONFIG5, interpolation=InterMode.INTER_CUBIC, mean=(104.0, 117.0, 123.0),
         stddev=(57.1, 57.4, 58.4)),
    dict(CONFIG5, out_layout=Layout.HWC),
    dict(warp=(M5, (112, 64)), out_size=(32, 32)),
    dict(CONFIG5, color_code=ColorCode.COLOR_YUV2BGR_NV21),
], ids=["cubic_static", "hwc_out", "no_crop", "nv21"])
def test_config5_variants_match_jax(fields):
    """A cubic resize with static stats, an HWC output, no crop and NV21
    input all take the warp route and match the JAX chain."""
    cfg, jc = config_pair(**fields)
    batch = frames5(13) if cfg.color_code is None else nv_frames(13, h=144, w=256)
    want = jax_pre_batch(jc, batch, "jnp")
    pre = Preprocessor(cfg)
    assert pre.describe_route(batch.shape[1:]) == "warp_torch"
    assert_close(pre.batch(batch).numpy(), want)
    assert_close(pre(batch[0]).numpy(), want[0])


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_config5_runtime_top_matches_moved_rect(backend):
    cfg, _ = config_pair(**CONFIG5)
    _, moved = config_pair(**dict(CONFIG5, crop_rect=(6, 1, 250, 137)))
    batch = frames5(14)
    want = jax_pre_batch(moved, batch, "jnp")
    pre = Preprocessor(cfg)
    with config.backend(backend):
        for top in (1, torch.tensor(1, dtype=torch.int32)):
            assert_close(pre.batch(batch, top=top).numpy(), want)
        far = pre.batch(batch, top=torch.tensor(999)).numpy()
        np.testing.assert_array_equal(far, pre.batch(batch, top=144 - 136).numpy())


def test_config5_describe_route():
    cfg, _ = config_pair(**CONFIG5)
    assert Preprocessor(cfg).describe_route((144, 256, 3)) == "warp_torch"
    assert Preprocessor(cfg, device="cuda").describe_route((144, 256, 3)) == "cuda_warp"
    assert Preprocessor(cfg).describe_route((144, 256, 3), device="cuda") == "cuda_warp"
    # The warp route takes any frame shape and type, whatever the resize.
    assert Preprocessor(cfg).describe_route((144, 256, 3), torch.float32) == "warp_torch"
    cubic, _ = config_pair(**dict(CONFIG5, interpolation=InterMode.INTER_CUBIC))
    assert Preprocessor(cubic).describe_route((144, 256, 3)) == "warp_torch"
    with config.backend("torch"):
        assert Preprocessor(cfg).describe_route((144, 256, 3)) == "torch_chain"


# ---- colour codes off the NV path: cvt_color first, then the chain ----

COLOR_CONFIGS = {
    "bgr2rgb": PreprocessConfig(color_code=ColorCode.COLOR_BGR2RGB, crop_rect=VRect(*RECT),
                                out_size=(112, 96)),
    "ycrcb_cubic": PreprocessConfig(color_code=ColorCode.COLOR_BGR2YCrCb, out_size=(128, 72),
                                    interpolation=InterMode.INTER_CUBIC),
    "gray": PreprocessConfig(color_code=ColorCode.COLOR_BGR2GRAY, crop_rect=VRect(*RECT),
                             out_size=(112, 96)),
    "hsv_static": PreprocessConfig(color_code=ColorCode.COLOR_BGR2HSV, out_size=(96, 64),
                                   mean=(90.0, 100.0, 110.0), stddev=(50.0, 60.0, 70.0)),
    "rgb_warp": PreprocessConfig(color_code=ColorCode.COLOR_BGR2RGB, crop_rect=VRect(*RECT),
                                 warp=(((0.9, 0.03, 4.0), (-0.03, 0.9, 2.5)), (256, 144)),
                                 out_size=(112, 96)),
    "gray_warp": PreprocessConfig(color_code=ColorCode.COLOR_BGR2GRAY,
                                  warp=(((0.8, 0.0, 3.0), (0.0, 0.8, 1.0)), (200, 120)),
                                  out_size=(64, 48)),
}


@pytest.mark.parametrize("name", list(COLOR_CONFIGS))
@pytest.mark.parametrize("port_backend", ["auto", "torch"])
def test_non_nv_colour_codes_match_jax_preprocessor(name, port_backend):
    """Any colour code runs through cvt_color first, as the JAX
    Preprocessor's chain does (vacv_tpu/models/pipeline.py:34-49)."""
    cfg = COLOR_CONFIGS[name]
    batch = frames(20)
    want = jax_batch(cfg, batch, "jnp")
    pre = Preprocessor(cfg)
    with config.backend(port_backend):
        route = pre.describe_route(batch.shape[1:])
        got = pre.batch(batch).numpy()
    if port_backend == "torch":
        assert route == "torch_chain"
    else:
        assert route == ("warp_torch" if cfg.warp is not None else "torch_chain")
    assert_close(got, want)
