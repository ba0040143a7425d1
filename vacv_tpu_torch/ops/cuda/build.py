"""Build the package's CUDA kernels with ``nvcc`` and load them by ctypes.

The sources are ``vacv_tpu_torch/csrc/*.cu`` (and the ``*.cuh`` headers
they share).  They have a plain C interface, so they need no PyTorch
headers: one ``nvcc`` per source compiles it to an object, all started
together, and one more links the objects into a shared library, in
seconds.  The library lands in
``build/vacv_tpu_torch/`` beside the package, under a name keyed by a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the last build.  Nothing here runs at import: the first CUDA call
builds (``library()``).

This module is also the one door through which the wrappers in
``ops/cuda/`` reach the library:

* ``entry(name)``: a C entry point, its types set from ``ENTRIES``, the
  one table that states them; ``limits`` reads a ``vacv_*_limits`` entry.
* ``call(fn, args, what)``: every call that launches work.  It counts
  ``native.calls`` and, with the tracer's spans on (``utils/trace.py``), is
  timed as span ``native.call`` inside its wrapper's span ``ops.<route>``
  (the route the call counts); a CUDA error code raises (``check``).
* ``Launch``: a call prepared ahead, run per batch (``FusedLaunch``,
  ``WarpLaunch``); ``traced`` gives a wrapper that calls the library itself
  its ``ops.<route>`` span.
* ``dispatch``: the public wrappers' one skeleton, the kernel on a CUDA
  tensor and the plain PyTorch version on a CPU one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from ... import config
from ...utils import trace

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "vacv_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--split-compile", "0",  # a source's kernels optimised in parallel (CUDA 12.1 on)
    "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Build:
    path: Path
    log: str          # nvcc's output (the -Xptxas -v register/smem lines)
    seconds: float    # compile time; 0 when an earlier build was reused
    lib: ctypes.CDLL


def _nvcc() -> str:
    root = os.environ.get("CUDA_HOME")
    if root and (Path(root) / "bin" / "nvcc").exists():
        return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


@functools.lru_cache(maxsize=1)
def library() -> Build:
    """Compile (or reuse) and load the kernel library."""
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"libvacv_kernels_{digest.hexdigest()[:16]}.so"
    log, seconds = "", 0.0
    if not out.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / f"{p.stem}.o" for p in srcs if p.suffix == ".cu"]
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(SRC_DIR / f"{o.stem}.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for o in objs
            ]  # all started together
            failed = []
            for o, proc in zip(objs, procs):
                text, _ = proc.communicate()
                log += f"[{o.stem}.cu]\n{text}"
                if proc.returncode != 0:
                    failed.append(o.stem)
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
            lib = Path(tmp) / "lib.so"
            proc = subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
            os.replace(lib, out)  # atomic: a concurrent build never sees half a file
        seconds = time.perf_counter() - t0
    return Build(out, log, seconds, ctypes.CDLL(str(out)))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's SM count, which the wrappers' split plans fill."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_i, _p, _f, _ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
# The fused kernel's crop and taps: left, ch, top, top_ptr, oh, ow, ystart, ywt, ky, xstart,
# xwt, kx; its static statistics: mean[3], std[3].
_GEOM = [_i, _i, _i, _p, _i, _i, _p, _p, _i, _p, _p, _i]
_STATS = [_f] * 6
_TAIL = _GEOM + [_i, _f, _i] + _STATS  # trunc_u8, eps, static_norm
# The argument types of every C entry point of the library (csrc/*.cu), each
# stated here alone.  Each returns an int, a CUDA error code, bar the one
# in ``_RESULT``.
ENTRIES = {
    # device, stream, src, out, n, h, w, planar
    "vacv_preprocess_resize": [_i, _p, _p, _p, _i, _i, _i, _i] + _TAIL,
    # device, stream, src, out, planes, slots, n, h, w, planar, geometry, eps, blocks,
    # have_mean, have_std, stats
    "vacv_preprocess_moments": [_i, _p, _p, _p, _p, _p, _i, _i, _i, _i] + _GEOM
    + [_f, _i, _i, _i] + _STATS,
    # device, stream, src, out, n, h, w, is_nv12, to_rgb
    "vacv_preprocess_nv_resize": [_i, _p, _p, _p, _i, _i, _i, _i, _i] + _TAIL,
    # device, stream, src, out, n, h, w, is_nv12, to_rgb, geometry, eps, blocks, rows, chan,
    # have_mean, have_std, evict_first, slots, stats
    "vacv_preprocess_nv_one_pass": [_i, _p, _p, _p, _i, _i, _i, _i, _i] + _GEOM
    + [_f, _i, _i, _i, _i, _i, _i, _p] + _STATS,
    # device, stream, out, planes, plane, have_mean, have_std, stats
    "vacv_preprocess_normalize": [_i, _p, _p, _i, _ll, _i, _i] + _STATS,
    "vacv_preprocess_limits": [_i, _p],  # device, int[4]
    # device, stream, src, out, the device top (or null), the fixed arguments (WarpMomentsArgs)
    "vacv_preprocess_warp_moments": [_i, _p, _p, _p, _p, _p],
    # device, stream, x, is_u8, out, planes, plane, cluster, grid, per_plane, slice, cap,
    # rounds, evict_first, part
    "vacv_normalize_planes": [_i, _p, _p, _i, _p, _i, _ll, _i, _i, _i, _i, _i, _i, _i, _p],
    "vacv_normalize_limits": [_i, _p],  # device, int[7]
    # device, stream, y, y_stride, vu, vu_stride, out, h, w, is_nv12, vec
    "vacv_yuv2bgr": [_i, _p, _p, _ll, _p, _ll, _p, _i, _i, _i, _i],
    "vacv_warp_affine": [
        _i, _p, _p, _i, _i, _i, _i, _i,   # device, stream, src, is_u8, n, c, h, w
        _ll, _ll, _ll, _ll,               # source strides n, c, y, x
        _p, _i, _i, _ll, _ll, _ll, _ll,   # out, h_out, w_out, output strides n, c, y, x
        _f, _f, _f, _f, _f, _f,           # the inverse matrix
        _i, _i, _f, _i, _i,               # interp, border, border value, vacv, mode
        _p, _i,                           # the device top (or null), the frames' rows
    ],
    # device, stream, img, c, h, w, strides c/y/x, template, th, tw, out, splits
    "vacv_match_corr": [_i, _p, _p, _i, _i, _i, _ll, _ll, _ll, _p, _i, _i, _p, _i],
    # device, stream, x, c, h, w, strides c/y/x, th, tw, sq, sums, rows, threads, kr, kc
    "vacv_window_sum": [_i, _p, _p, _i, _i, _i, _ll, _ll, _ll, _i, _i, _p, _p, _i, _i, _i, _i],
    # device, stream, frames, out, index, matrices, faces, the fixed arguments (AlignArgs)
    "vacv_align_faces": [_i, _p, _p, _p, _p, _p, _i, _p],
    # device, stream, a, lda, b, ldb, out, m, k, n, reps, splits, is_i8
    "vacv_probe_mma": [_i, _p, _p, _ll, _p, _ll, _p, _i, _i, _i, _i, _i, _i],
    "vacv_cuda_error_string": [_i],
}
_RESULT = {"vacv_cuda_error_string": ctypes.c_char_p}


@functools.lru_cache(maxsize=None)
def entry(name: str):
    """The library's C entry point ``name``, its types set from ``ENTRIES``."""
    fn = getattr(library().lib, name)
    fn.restype, fn.argtypes = _RESULT.get(name, _i), ENTRIES[name]
    return fn


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({entry('vacv_cuda_error_string')(rc).decode()})")


def limits(name: str, device_index, n: int) -> tuple[int, ...]:
    """The ``n`` ints that entry ``name`` (a ``vacv_*_limits``) reports of
    card ``device_index``; not a launch, so not counted."""
    out = (ctypes.c_int * n)()
    check(entry(name)(device_index, ctypes.cast(out, ctypes.c_void_p)), name)
    return tuple(out)


def call(fn, args, what: str) -> None:
    """Call entry ``fn`` (``entry``) with ``args``, work it launches: span
    ``native.call`` with spans on, counter ``native.calls``, RuntimeError
    through ``check`` with ``what`` on a CUDA error."""
    span = trace.begin("native.call") if trace.ON else None
    rc = fn(*args)
    if span is not None:
        trace.end(span)
    trace.count("native.calls")
    check(rc, what)


def _span(route: str) -> str:
    """The span that traces a call of ``route`` (a route counter's name)."""
    return "ops." + route


def traced(route: str):
    """Decorate a wrapper's launch that calls the library itself (not
    through a ``Launch``) to run in span ``ops.<route>`` with spans on."""
    name = _span(route)

    def wrap(launch):
        @functools.wraps(launch)
        def run(*args):
            span = trace.begin(name) if trace.ON else None
            try:
                return launch(*args)
            finally:
                if span is not None:
                    trace.end(span)

        return run

    return wrap


def dispatch(route: str, x: torch.Tensor, card, plain):
    """The public wrappers' one skeleton, on the device of their tensor
    ``x``: a CUDA tensor returns ``card()``, the kernel's launch (traced as
    span ``ops.<route>`` by a ``Launch``'s ``run`` or by ``traced``); a CPU
    tensor returns ``plain()``, the plain PyTorch version, in span
    ``ops.<route>_torch``, counted as ``<route>_torch``; any other device
    raises ValueError naming the route, counting nothing."""
    kind = x.device.type
    if kind == "cuda":
        return card()
    if kind != "cpu":
        raise ValueError(f"no {route} route for device {x.device}")
    span = trace.begin(_span(route + "_torch")) if trace.ON else None
    try:
        out = plain()
        config.record_kernel(route + "_torch")
        return out
    finally:
        if span is not None:
            trace.end(span)


class Launch:
    """One call of entry ``fn``, prepared: its arguments ``args`` with
    every static field filled in, and what those arguments point at
    (``held``), kept so that it outlives the caches it came from.

    The per-call part (``_run``) allocates the ``shape`` / ``dtype`` output
    on ``device`` unless given one, puts in the source's address at slot 2,
    the output's at ``out_at`` and the top by its kind (``top_kind``): none;
    an int clamped to ``[0, top_hi]`` at ``top_at``; a tensor by the address
    of an int32 on the device at ``top_ptr_at``, a copy (``"cast"``) unless
    the top is one (``"device"``), which the kernel reads and clamps itself,
    so a moving ROI never synchronises the host.  Then it makes the call
    (``call``), and any more a subclass makes (``_more``), counts the route
    and returns the output.  Traced as span ``ops.<route>``.  A record runs
    only sources of the shape, strides, type and device it was prepared
    for, on the CUDA stream that was current then, with a top of its
    kind."""

    __slots__ = ("route", "span", "device", "shape", "dtype", "fn", "args", "what", "out_at",
                 "top_at", "top_ptr_at", "top_mode", "top_hi", "held")

    def __init__(self, route, device, shape, dtype):
        self.route, self.span, self.device = route, _span(route), device
        self.shape, self.dtype = shape, dtype
        self.fn = self.args = self.what = self.top_mode = None
        self.out_at = self.top_at = self.top_ptr_at = self.top_hi = 0
        self.held = ()

    def bind(self, name, args, what, out_at=3):
        """Entry ``name`` and its arguments; ``what`` names it in errors."""
        self.fn, self.args, self.what, self.out_at = entry(name), args, what, out_at

    def top_kind(self, top, top_ptr_at, top_at=0, top_hi=0):
        """The kind of top the record takes, from ``top``: None, an int
        (clamped to ``[0, top_hi]``, at ``top_at``) or a tensor (by its
        address, at ``top_ptr_at``)."""
        self.top_ptr_at = top_ptr_at
        if isinstance(top, torch.Tensor):
            same = top.dtype == torch.int32 and top.device == self.device
            self.top_mode = "device" if same else "cast"
        elif top is not None:
            self.top_mode, self.top_at, self.top_hi = "int", top_at, top_hi

    def _more(self, out) -> None:
        """The calls after the first (none here)."""

    def _run(self, src: int, top, out):
        span = trace.begin(self.span) if trace.ON else None
        try:
            if out is None:
                out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
            if self.fn is None:  # nothing to launch
                return out
            args = list(self.args)
            args[2] = src
            args[self.out_at] = out.data_ptr()
            if self.top_mode == "int":
                args[self.top_at] = min(max(int(top), 0), self.top_hi)
            elif self.top_mode is not None:
                if self.top_mode == "cast":
                    top = top.reshape(()).to(device=self.device, dtype=torch.int32)
                args[self.top_ptr_at] = top.data_ptr()
            call(self.fn, args, self.what)
            self._more(out)
            config.record_kernel(self.route)
            return out
        finally:
            if span is not None:
                trace.end(span)
