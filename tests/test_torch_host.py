"""The port's host utilities against the JAX package's: ``utils/io``,
``native`` (the C++ host library), ``utils/loader`` and ``imencode``.

The same numpy inputs go through both packages.  ``bgr2nv21`` and the
NV decode are integer math: bit-exact; ``imencode`` under cv2 gives the
same bytes.
"""
import threading

import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu import native as jnative
from vacv_tpu.utils import io as jio
from vacv_tpu.utils.loader import BatchLoader as JLoader
from vacv_tpu_torch import config, native
from vacv_tpu_torch.utils import io as tio
from vacv_tpu_torch.utils.loader import BatchLoader

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


def bgr(seed, h=48, w=64):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Six 48x64 JPEGs and two PNGs on disk."""
    d = tmp_path_factory.mktemp("imgs")
    paths = []
    for i in range(6):
        p = str(d / f"f{i}.jpg")
        cv2.imwrite(p, bgr(i))
        paths.append(p)
    for i in range(2):
        p = str(d / f"g{i}.png")
        cv2.imwrite(p, bgr(10 + i))
        paths.append(p)
    return paths


# ---- utils/io ----------------------------------------------------------

@pytest.mark.parametrize("h,w", [(48, 64), (47, 64), (2, 2)])
def test_bgr2nv21_numpy_and_dispatcher_match_jax(h, w):
    img = bgr(h + w, h, w)
    want = jio.bgr2nv21_numpy(img)
    np.testing.assert_array_equal(tio.bgr2nv21_numpy(img), want)
    np.testing.assert_array_equal(tio.bgr2nv21(img), want)
    np.testing.assert_array_equal(tio.bgr2nv21(img), jio.bgr2nv21(img))
    for a, b in zip(tio.nv21_planes(want, w, h), jio.nv21_planes(want, w, h)):
        np.testing.assert_array_equal(a, b)


def test_bgr2nv21_refuses_an_odd_width():
    with pytest.raises(ValueError):
        tio.bgr2nv21_numpy(bgr(1, 4, 5))


def test_imread_matches_jax(jpegs):
    for p in (jpegs[0], jpegs[-1]):
        np.testing.assert_array_equal(tio.imread(p), jio.imread(p))
    with pytest.raises(FileNotFoundError):
        tio.imread(jpegs[0] + ".missing")


# ---- native ------------------------------------------------------------

def test_native_builds_into_the_port_build_dir():
    assert native.available()
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libvacv_host_")
    assert native.has_jpeg() == native.JPEG_HEADER.exists()


@pytest.mark.parametrize("h,w", [(144, 176), (48, 64), (2, 2)])
def test_native_bgr2nv21_and_nv_to_bgr_bit_exact_to_jax(h, w):
    img = bgr(h * w, h, w)
    k0 = config.kernel_count("native_bgr2nv21")
    nv = native.bgr2nv21(img)
    assert config.kernel_count("native_bgr2nv21") == k0 + 1
    np.testing.assert_array_equal(nv, jnative.bgr2nv21(img))
    np.testing.assert_array_equal(nv, jio.bgr2nv21_numpy(img))
    y, vu = tio.nv21_planes(nv, w, h)
    for is_nv12 in (False, True):
        got = native.nv_to_bgr(y, vu, is_nv12=is_nv12)
        np.testing.assert_array_equal(got, jnative.nv_to_bgr(y, vu, is_nv12=is_nv12))
        np.testing.assert_array_equal(got, native._nv_to_bgr_numpy(y, vu, is_nv12))


def test_native_bgr2nv21_refuses_odd_sizes():
    with pytest.raises(ValueError):
        native.bgr2nv21(bgr(2, 5, 8))


def test_native_cosine_matches_jax():
    a, b = bgr(3), bgr(4)
    k0 = config.kernel_count("native_cosine")
    assert native.cosine(a, b) == pytest.approx(jnative.cosine(a, b), abs=1e-12)
    f, g = a.astype(np.float32), b.astype(np.float32)
    assert native.cosine(f, g) == pytest.approx(jnative.cosine(f, g), abs=1e-12)
    assert config.kernel_count("native_cosine") == k0 + 2
    p0 = config.kernel_count("numpy_cosine")
    assert native.cosine(a.astype(np.float64), b) == pytest.approx(
        vt.utils.compare.cosine_similarity(a, b))
    assert config.kernel_count("numpy_cosine") == p0 + 1
    with pytest.raises(ValueError):
        native.cosine(a, b[:-1])


def test_native_jpeg_decode_matches_jax(jpegs):
    if not native.has_jpeg():
        pytest.skip("built without libjpeg")
    got = native.imread_jpeg(jpegs[1])
    np.testing.assert_array_equal(got, jnative.imread_jpeg(jpegs[1]))
    with open(jpegs[1], "rb") as f:
        np.testing.assert_array_equal(native.decode_jpeg(f.read(), bgr=False), got[..., ::-1])
    with pytest.raises(ValueError):
        native.decode_jpeg(b"not a jpeg")


def test_native_fallbacks_without_a_library(monkeypatch):
    """Without a toolchain every entry point takes its numpy fallback,
    counted numpy_*."""
    monkeypatch.setattr(native, "_load", lambda: None)
    img = bgr(5)
    k0, n0 = config.kernel_count("numpy_bgr2nv21"), config.kernel_count("numpy_nv_to_bgr")
    nv = native.bgr2nv21(img)
    np.testing.assert_array_equal(nv, jio.bgr2nv21_numpy(img))
    y, vu = tio.nv21_planes(nv, 64, 48)
    np.testing.assert_array_equal(native.nv_to_bgr(y, vu), jnative.nv_to_bgr(y, vu))
    assert config.kernel_count("numpy_bgr2nv21") == k0 + 1
    assert config.kernel_count("numpy_nv_to_bgr") == n0 + 1
    assert not native.available() and not native.has_jpeg()
    with pytest.raises(RuntimeError):
        native.decode_jpeg(b"")


def test_concurrent_builds_all_load_one_library(tmp_path, monkeypatch):
    """Four threads build a fresh directory at once: each compiles into a
    temporary file and moves it into place atomically, so all end with
    the same whole library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    paths, errors = [], []

    def go():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001  (collected and asserted below)
            errors.append(e)

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    lib = __import__("ctypes").CDLL(str(paths[0]))
    assert lib.vacv_native_version() == 1
    assert [p.name for p in (tmp_path / "b").iterdir()] == [paths[0].name]


# ---- utils/loader --------------------------------------------------------

@pytest.mark.parametrize("drop", [True, False])
def test_batch_loader_matches_jax(jpegs, drop):
    got = list(BatchLoader(jpegs, batch_size=3, num_threads=2, drop_remainder=drop))
    want = list(JLoader(jpegs, batch_size=3, num_threads=2, drop_remainder=drop))
    assert len(got) == len(want) == (2 if drop else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_loader_resizes_like_jax(jpegs):
    got = next(iter(BatchLoader(jpegs[:2], batch_size=2, resize_to=(32, 24))))
    want = next(iter(JLoader(jpegs[:2], batch_size=2, resize_to=(32, 24))))
    assert got.shape == (2, 24, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_to_device_gives_tensors_on_the_default_device(jpegs):
    host = list(BatchLoader(jpegs, batch_size=4))
    dev = list(BatchLoader(jpegs, batch_size=4).to_device())
    assert all(isinstance(b, torch.Tensor) and b.device.type == "cpu" for b in dev)
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h, d.numpy())
    with config.device("cuda"), pytest.raises(RuntimeError, match=r'config.device\("cpu"\)'):
        next(iter(BatchLoader(jpegs, batch_size=4).to_device()))


# ---- imencode ------------------------------------------------------------

@pytest.mark.parametrize("ext", [".jpg", "png", ".bmp"])
def test_imencode_bytes_equal_jax(ext):
    img = bgr(7)
    want = vc.imencode(img, ext)
    assert vt.imencode(img, ext) == want
    assert vt.imencode(torch.from_numpy(img), ext) == want
    chw = vt.Image(torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1))), vt.CHW)
    assert vt.imencode(chw, ext) == want


def test_imencode_params_and_float_input_match_jax():
    img = bgr(8)
    q = [cv2.IMWRITE_JPEG_QUALITY, 40]
    assert vt.imencode(img, ".jpg", q) == vc.imencode(img, ".jpg", q)
    f = img.astype(np.float32) * 1.5 - 20  # clipped to [0, 255] and truncated
    assert vt.imencode(f, ".png") == vc.imencode(f, ".png")
    half = torch.from_numpy(img).to(torch.bfloat16)
    assert vt.imencode(half, ".png") == vc.imencode(img, ".png")
