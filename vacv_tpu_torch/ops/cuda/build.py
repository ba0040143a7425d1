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

Every call into the library that launches work counts ``native.calls``
and, with the tracer's spans on (``utils/trace.py``), is timed as span
``native.call`` inside its wrapper's span ``ops.<the route it records>``.
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
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        fn = lib.vacv_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc} ({fn(rc).decode()})")
