"""ctypes bindings for the native host utilities (``native/vacv_host.cpp``).

The counterpart of ``vacv_tpu/native/__init__.py``: camera-format
synthesis and decode, JPEG decode and the cosine metric, in C++ with
OpenMP (the x86 role of the reference's NEON util layer, ``src/util/``).
The C++ file is a source of the repository, read by path; at first use
it is built with ``g++`` and the flags of ``native/Makefile`` (with
``-DVACV_WITH_JPEG -ljpeg`` when ``jpeglib.h`` is there) into
``build/vacv_tpu_torch/``, under a name keyed by a hash of the source, the
flags and the host's CPU (``-march=native``), and moved into place
atomically, so a concurrent build never loads half a file.

Every entry point keeps the JAX module's numpy fallback for a host
without a toolchain.  Which route served a call is counted with
``config.record_kernel``: ``native_<name>`` or ``numpy_<name>``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from . import config

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "vacv_host.cpp"
BUILD_DIR = _ROOT / "build" / "vacv_tpu_torch"
JPEG_HEADER = Path("/usr/include/jpeglib.h")
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-Wall", "-Wextra", "-std=c++17",
             "-shared")

_lock = threading.Lock()
build_error: str | None = None  # why the library could not be built, if it could not


def _flags() -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(compile flags, libraries) as native/Makefile sets them."""
    if JPEG_HEADER.exists():
        return CXX_FLAGS + ("-DVACV_WITH_JPEG",), ("-ljpeg",)
    return CXX_FLAGS, ()


def _cpu_key() -> str:
    """What ``-march=native`` depends on: the CPU's feature flags."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("flags"):
                return line
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> Path:
    flags, libs = _flags()
    digest = hashlib.sha256(" ".join(flags + libs).encode())
    digest.update(_cpu_key().encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvacv_host_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host library unless a build of this source, these
    flags and this CPU exists; returns its path."""
    out = library_path()
    if not out.exists():
        flags, libs = _flags()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            lib = Path(tmp) / "lib.so"
            # g++ from PATH, not $CXX: a toolchain wrapper there may lack
            # OpenMP's spec file.
            subprocess.run(["g++", *flags, "-o", str(lib), str(SOURCE), *libs], check=True,
                           capture_output=True, text=True, timeout=300)
            os.replace(lib, out)  # atomic: a concurrent build never sees half a file
    return out


@functools.lru_cache(maxsize=1)
def _load():
    """The bound library, or None where it cannot be built (no compiler):
    the callers then take their numpy fallbacks."""
    global build_error
    with _lock:
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError) as e:
            build_error = f"{e}\n{getattr(e, 'stderr', '') or ''}".strip()
            return None
    i, p, sz = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
    pi = ctypes.POINTER(ctypes.c_int)
    for name, res, args in (
        ("vacv_bgr2nv21", i, [p, p, i, i]),
        ("vacv_nv_to_bgr", None, [p, p, p, i, i, i]),
        ("vacv_cosine_f32", ctypes.c_double, [p, p, sz]),
        ("vacv_cosine_u8", ctypes.c_double, [p, p, sz]),
        ("vacv_has_jpeg", i, []),
        ("vacv_jpeg_dims", i, [p, sz, pi, pi, pi]),
        ("vacv_decode_jpeg", i, [p, sz, p, i]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def available() -> bool:
    return _load() is not None


def bgr2nv21(bgr: np.ndarray) -> np.ndarray:
    """BGR (h, w, 3) u8 → flat NV21 buffer, bit-exact with the reference
    (``image_util.cpp:3-41``); even width and height."""
    lib = _load()
    h, w, _ = bgr.shape
    if lib is None:
        from .utils.io import bgr2nv21_numpy

        config.record_kernel("numpy_bgr2nv21")
        return bgr2nv21_numpy(bgr)
    if h % 2 or w % 2:
        raise ValueError("bgr2nv21 requires even width and height")
    src = np.ascontiguousarray(bgr, dtype=np.uint8)
    out = np.empty(h * w + (h // 2) * w, dtype=np.uint8)
    if lib.vacv_bgr2nv21(_ptr(src), _ptr(out), w, h) != 0:
        raise ValueError("bgr2nv21 failed")
    config.record_kernel("native_bgr2nv21")
    return out


def _nv_to_bgr_numpy(y: np.ndarray, vu: np.ndarray, is_nv12: bool) -> np.ndarray:
    """The Q7 decode in numpy (the JAX module's fallback)."""
    h, w = y.shape
    vu32 = vu.astype(np.int32)
    u_s, v_s = (vu32[:, 0::2], vu32[:, 1::2]) if is_nv12 else (vu32[:, 1::2], vu32[:, 0::2])
    v = np.repeat(np.repeat(v_s, 2, 0), 2, 1)[:h, :w] - 128
    u = np.repeat(np.repeat(u_s, 2, 0), 2, 1)[:h, :w] - 128
    yy = y.astype(np.int32)
    ra, ga, ba = (179 * v) >> 7, (44 * u + 91 * v) >> 7, (227 * u) >> 7
    return np.stack([np.clip(yy + ba, 0, 255), np.clip(yy - ga, 0, 255),
                     np.clip(yy + ra, 0, 255)], axis=-1).astype(np.uint8)


def nv_to_bgr(y: np.ndarray, vu: np.ndarray, is_nv12: bool = False) -> np.ndarray:
    """Host-side NV decode: Y (h, w) + VU (⌈h/2⌉, w) u8 → BGR (h, w, 3) u8."""
    lib = _load()
    if lib is None:
        config.record_kernel("numpy_nv_to_bgr")
        return _nv_to_bgr_numpy(y, vu, is_nv12)
    h, w = y.shape
    ys = np.ascontiguousarray(y, dtype=np.uint8)
    vus = np.ascontiguousarray(vu, dtype=np.uint8)
    out = np.empty((h, w, 3), dtype=np.uint8)
    lib.vacv_nv_to_bgr(_ptr(ys), _ptr(vus), _ptr(out), w, h, int(is_nv12))
    config.record_kernel("native_nv_to_bgr")
    return out


def has_jpeg() -> bool:
    lib = _load()
    return lib is not None and bool(lib.vacv_has_jpeg())


def decode_jpeg(data: bytes, bgr: bool = True) -> np.ndarray:
    """Decode a JPEG byte buffer to HWC u8 (BGR by default, like
    cv::imread).  Raises RuntimeError without the library or libjpeg:
    callers fall back to cv2/PIL through ``utils.io.imread``."""
    if not has_jpeg():
        raise RuntimeError("native jpeg decode unavailable")
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.vacv_jpeg_dims(_ptr(buf), buf.size, ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(c)) != 0:
        raise ValueError("invalid JPEG data")
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    if lib.vacv_decode_jpeg(_ptr(buf), buf.size, _ptr(out), int(bgr)) != 0:
        raise ValueError("JPEG decode failed")
    config.record_kernel("native_decode_jpeg")
    return out


def imread_jpeg(path: str, bgr: bool = True) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), bgr)


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    """Cosine similarity in the library for two u8 or two f32 arrays, else
    (or without the library) ``utils.compare.cosine_similarity``."""
    lib = _load()
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    fn = None
    if lib is not None and a.dtype == b.dtype == np.uint8:
        fn = lib.vacv_cosine_u8
    elif lib is not None and a.dtype == b.dtype == np.float32:
        fn = lib.vacv_cosine_f32
    if fn is not None:
        config.record_kernel("native_cosine")
        return float(fn(_ptr(a), _ptr(b), a.size))
    from .utils.compare import cosine_similarity

    config.record_kernel("numpy_cosine")
    return cosine_similarity(a, b)
