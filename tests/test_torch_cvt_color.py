"""vacv_tpu_torch NV12/NV21 decode against vacv_tpu and the numpy oracle.

The same numpy NV buffers go through the port's ``cvt_color`` and
``nv_to_bgr_planes_torch`` (what the yuv2bgr CUDA kernel is held to on
the card), the JAX ``cvt_color`` / ``nv_to_bgr_planes_jnp``, the JAX
Pallas ``nv_to_bgr_pallas`` in interpret mode, and
``tests/oracle.py::nv_to_bgr``.  Q7 decode is integer math: every
comparison is bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu import config as jconfig
from vacv_tpu.ops.cvt_color import nv_to_bgr_planes_jnp
from vacv_tpu.ops.pallas.yuv2bgr import nv_to_bgr_pallas
from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import ColorCode
from vacv_tpu_torch.ops.cuda.yuv2bgr import nv_to_bgr
from vacv_tpu_torch.ops.cvt_color import nv_to_bgr_planes, nv_to_bgr_planes_torch

from oracle import nv_to_bgr as oracle_nv_to_bgr

NV_CODES = [
    "COLOR_YUV2RGB_NV12", "COLOR_YUV2BGR_NV12", "COLOR_YUV2RGB_NV21", "COLOR_YUV2BGR_NV21",
    "COLOR_YUV2RGBA_NV12", "COLOR_YUV2BGRA_NV12", "COLOR_YUV2RGBA_NV21", "COLOR_YUV2BGRA_NV21",
]


def nv_buffer(seed, h, w):
    """A stacked (h + ceil(h/2), w) buffer; any bytes are a valid NV frame."""
    return np.random.default_rng(seed).integers(0, 256, (h + (h + 1) // 2, w), dtype=np.uint8)


def planes(buf, h):
    return buf[:h], buf[h:]


@pytest.mark.parametrize("name", NV_CODES)
@pytest.mark.parametrize("h,w", [(144, 176), (143, 176)])
def test_cvt_color_matches_jax_all_codes(name, h, w):
    buf = nv_buffer(0, h, w)
    want = np.asarray(vc.cvt_color(buf, getattr(vc.ColorCode, name)).data)
    got = vt.cvt_color(buf, getattr(ColorCode, name))
    assert got.layout == vt.HWC and got.dtype == torch.uint8
    assert got.shape == want.shape == (h, w, 4 if "A_" in name else 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # Against the oracle: BGR order, reversed for RGB, alpha all 255.
    bgr = oracle_nv_to_bgr(*planes(buf, h), is_nv12="NV12" in name)
    rgb_first = name.startswith("COLOR_YUV2RGB")
    np.testing.assert_array_equal(got.numpy()[..., :3], bgr[..., ::-1] if rgb_first else bgr)
    if "A_" in name:
        assert (got.numpy()[..., 3] == 255).all()


@pytest.mark.parametrize("is_nv12", [False, True])
@pytest.mark.parametrize("h,w", [(144, 176), (175, 144), (360, 640), (1, 2)])
def test_plain_planes_match_jnp_pallas_and_oracle(is_nv12, h, w):
    buf = nv_buffer(1, h, w)
    y, vu = planes(buf, h)
    got = [p.numpy() for p in nv_to_bgr_planes_torch(torch.from_numpy(y), torch.from_numpy(vu),
                                                      is_nv12=is_nv12)]
    jnp_out = nv_to_bgr_planes_jnp(jnp.asarray(y), jnp.asarray(vu), is_nv12=is_nv12)
    with jconfig.backend("pallas"):
        pallas_out = nv_to_bgr_pallas(jnp.asarray(y), jnp.asarray(vu), is_nv12=is_nv12)
    oracle = oracle_nv_to_bgr(y, vu, is_nv12)
    for c in range(3):
        assert got[c].shape == (h, w) and got[c].dtype == np.uint8
        np.testing.assert_array_equal(got[c], np.asarray(jnp_out[c]))
        np.testing.assert_array_equal(got[c], np.asarray(pallas_out[c]))
        np.testing.assert_array_equal(got[c], oracle[..., c])


def test_negative_adders_floor():
    """Chroma bytes far from 128 drive every Q7 adder negative (and
    positive); the arithmetic shift must floor, as C's signed >> does."""
    chroma = np.array([0, 1, 2, 63, 127, 128, 129, 200, 254, 255], np.uint8)
    vv, uu = np.meshgrid(chroma, chroma, indexing="ij")
    pairs = np.stack([vv.ravel(), uu.ravel()], axis=-1).reshape(1, -1)  # NV21: V, U
    w = pairs.shape[1]
    y = np.tile(np.array([0, 5, 128, 250, 255], np.uint8).repeat(2)[:, None], (1, w))
    vu = np.repeat(pairs, y.shape[0] // 2, axis=0)
    for is_nv12 in (False, True):
        got = nv_to_bgr_planes_torch(torch.from_numpy(y), torch.from_numpy(vu), is_nv12=is_nv12)
        want = oracle_nv_to_bgr(y, vu, is_nv12)
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(), want[..., c])
    # The adders themselves: floor, not truncation toward zero.
    v = torch.tensor([-128, -1, 1, 127], dtype=torch.int32)
    np.testing.assert_array_equal(((179 * v) >> 7).numpy(), np.floor(179 * v.numpy() / 128))


def test_odd_width_raises():
    with pytest.raises(ValueError, match="even width"):
        vt.cvt_color(np.zeros((36, 25), np.uint8), ColorCode.COLOR_YUV2BGR_NV21)
    with pytest.raises(ValueError, match="even width"):
        nv_to_bgr_planes_torch(torch.zeros(4, 5, dtype=torch.uint8),
                               torch.zeros(2, 5, dtype=torch.uint8), is_nv12=False)
    with pytest.raises(ValueError):
        vc.cvt_color(np.zeros((36, 25), np.uint8), vc.COLOR_YUV2BGR_NV21)


def test_short_vu_plane_raises():
    """A VU plane shorter than ceil(h/2) rows raises on every route.  (The
    JAX kernel zero-pads one; the JAX jnp route cannot take one at all.)"""
    y, vu = torch.zeros(6, 4, dtype=torch.uint8), torch.zeros(2, 4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="VU plane has 2 rows, needs 3"):
        nv_to_bgr_planes_torch(y, vu, is_nv12=False)
    with pytest.raises(ValueError, match="needs 3"):
        nv_to_bgr(y, vu, is_nv12=False)
    with pytest.raises(Exception):
        nv_to_bgr_planes_jnp(jnp.zeros((6, 4), jnp.uint8), jnp.zeros((2, 4), jnp.uint8),
                             is_nv12=False)


@pytest.mark.parametrize("code", ["COLOR_YUV2BGR_YV12", "COLOR_GRAY2BGR", "COLOR_BGR2RGB",
                                  "COLOR_BGR2HSV"])
def test_codes_not_on_this_path_raise(code):
    with pytest.raises(NotImplementedError, match="queue 1 #12"):
        vt.cvt_color(np.zeros((6, 4, 3), np.uint8), getattr(ColorCode, code))


def test_wrapper_on_cpu_counts_plain_version():
    buf = torch.from_numpy(nv_buffer(2, 10, 8))
    y, vu = buf[:10], buf[10:]
    k0, p0 = config.kernel_count("yuv2bgr"), config.kernel_count("yuv2bgr_torch")
    got = nv_to_bgr(y, vu, is_nv12=True)
    want = nv_to_bgr_planes_torch(y, vu, is_nv12=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert config.kernel_count("yuv2bgr_torch") == p0 + 1
    # cvt_color decodes through the dispatcher: the wrapper under
    # "auto", the plain version (uncounted) under "torch".
    vt.cvt_color(buf, ColorCode.COLOR_YUV2BGR_NV12)
    assert config.kernel_count("yuv2bgr_torch") == p0 + 2
    with config.backend("torch"):
        torch_route = nv_to_bgr_planes(y, vu, is_nv12=True)
        vt.cvt_color(buf, ColorCode.COLOR_YUV2BGR_NV12)
    assert all(torch.equal(a, b) for a, b in zip(torch_route, want))
    assert config.kernel_count("yuv2bgr_torch") == p0 + 2
    assert config.kernel_count("yuv2bgr") == k0
    with pytest.raises(ValueError):
        nv_to_bgr(y.to("meta"), vu.to("meta"), is_nv12=True)


def test_roundtrip_of_a_synthesized_frame(bgr_640x360):
    """BGR → NV21 (the reference's integer synthesis) → the port's decode
    stays close to the original, as the reference's own check asks
    (test_cvt_color.cpp:47-49, bar 5e-4)."""
    from vacv_tpu.utils.compare import cosine_similarity
    from vacv_tpu.utils.io import bgr2nv21_numpy

    buf = bgr2nv21_numpy(bgr_640x360).reshape(540, 640)
    out = vt.cvt_color(buf, ColorCode.COLOR_YUV2BGR_NV21).numpy()
    assert abs(cosine_similarity(out, bgr_640x360) - 1) < 5e-4
