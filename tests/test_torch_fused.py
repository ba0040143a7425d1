"""vacv_tpu_torch's fused pipelines against vacv_tpu's on the CPU:
``resize_normalize`` and ``warp_affine_normalize(_rot)``.

The same seeded numpy images go through the JAX package (its jnp route,
and its Pallas kernels in interpret mode) and through the port (its
kernels' plain versions on CPU tensors).  Bar: cosine ≥ 1−1e-4 (the
repo's bar against OpenCV); the max-abs error is printed with each case.
"""
import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu import config as jconfig
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu_torch import config

M = np.array([[0.9, 0.04, 3.0], [-0.04, 0.9, 5.0]], np.float32)
STATS = dict(mean=(104.0, 117.0, 123.0), stddev=(57.1, 57.4, 58.4))


def image(seed, shape=(60, 80, 3), dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8).astype(dtype)


def assert_close(got: vt.Image, want: vc.Image):
    g, w = got.numpy(), np.asarray(want.data)
    assert g.shape == w.shape and g.dtype == np.float32
    assert got.layout.value == want.layout.value
    cos = cosine_similarity(g, w)
    print(f"1-cos={1 - cos:.3e} max_abs={np.abs(g - w).max():.3e}")
    assert cos >= 1 - 1e-4


@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("stats", ["self", "static"])
def test_resize_normalize_fused_input(jax_backend, stats):
    """u8 HWC bilinear: the fused preprocess kernel's route on both sides."""
    src = image(0)
    kw = {} if stats == "self" else STATS
    with jconfig.backend(jax_backend):
        want = vc.resize_normalize(src, (32, 24), **kw)
    p0 = config.kernel_count("preprocess_fused_torch")
    got = vt.resize_normalize(src, (32, 24), **kw)
    assert config.kernel_count("preprocess_fused_torch") == p0 + 1
    assert_close(got, want)


@pytest.mark.parametrize("case", ["f32", "cubic", "chw", "gray", "fx_fy"])
def test_resize_normalize_chain_inputs(case):
    src, kw = image(1), {}
    if case == "f32":
        src = src.astype(np.float32)
    elif case == "cubic":
        kw = dict(interpolation=vt.INTER_CUBIC)
    elif case == "gray":
        src = np.ascontiguousarray(src[..., 0])
    dsize = (0, 0) if case == "fx_fy" else (32, 24)
    if case == "fx_fy":
        kw = dict(fx=0.5, fy=0.25)
    jsrc, tsrc = src, src
    if case == "chw":
        chw = np.ascontiguousarray(src.transpose(2, 0, 1))
        jsrc, tsrc = vc.Image(chw, vc.CHW), vt.Image(torch.from_numpy(chw), vt.CHW)
    with jconfig.backend("jnp"):
        want = vc.resize_normalize(jsrc, dsize, **kw)
    p0 = config.kernel_count("preprocess_fused_torch")
    got = vt.resize_normalize(tsrc, dsize, **kw)
    fused = case == "fx_fy"  # u8 HWC bilinear, sized by fx/fy
    assert config.kernel_count("preprocess_fused_torch") == p0 + int(fused)
    assert_close(got, want)


@pytest.mark.parametrize("layout", ["HWC", "CHW"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("stats", ["self", "static"])
def test_warp_affine_normalize(layout, dtype, stats):
    src = image(2, dtype=dtype)
    kw = {} if stats == "self" else STATS
    jsrc, tsrc = src, src
    if layout == "CHW":
        chw = np.ascontiguousarray(src.transpose(2, 0, 1))
        jsrc, tsrc = vc.Image(chw, vc.CHW), vt.Image(torch.from_numpy(chw), vt.CHW)
    with jconfig.backend("jnp"):
        want = vc.warp_affine_normalize(jsrc, M, (56, 40), **kw)
    names = ("warp_affine_torch", "normalize_fused_torch")
    before = [config.kernel_count(k) for k in names]
    got = vt.warp_affine_normalize(tsrc, M, (56, 40), **kw)
    rose = [config.kernel_count(k) - b for k, b in zip(names, before)]
    # Self statistics on the planar f32 warp go to the normalize kernel's wrapper.
    assert rose == [1, int(stats == "self")]
    assert_close(got, want)


@pytest.mark.parametrize("border", [vt.BORDER_CONSTANT, vt.BORDER_REFLECT_101])
def test_warp_affine_normalize_rot(border):
    src = image(3)
    aux = (40.0, 30.0, 28.0, 20.0)
    with jconfig.backend("jnp"):
        want = vc.warp_affine_normalize_rot(src, 0.8, 25.0, (56, 40), vc.VScalar(*aux),
                                            border_mode=int(border))
    got = vt.warp_affine_normalize_rot(src, 0.8, 25.0, (56, 40), vt.VScalar(*aux),
                                       border_mode=border)
    assert_close(got, want)
    with jconfig.backend("pallas"):
        want = vc.warp_affine_normalize_rot(src, 0.8, 25.0, (56, 40), vc.VScalar(*aux),
                                            border_mode=int(border))
    assert_close(got, want)
