#!/usr/bin/env python3
"""Smoke test of vacv_tpu_torch on one NVIDIA GPU: build, check, drive, time.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda),
and exits non-zero when either is missing or any phase fails.

Phases, each printed as it runs:

1. device: the card's name and power limit, TF32 off for the plain
   versions' float32 matmuls;
2. build: the CUDA kernels from ``vacv_tpu_torch/csrc``, one ``nvcc`` per
   source started together, into ``build/vacv_tpu_torch/``, with nvcc's
   ``-Xptxas -v`` lines;
3. compare: every kernel against its plain PyTorch version on the card,
   at full width: the config-4 fused kernel (32 frames of 1080x1920, the
   BASELINE config-4 crop, 224x224 out) and odd frames; the NV fused
   kernel (32 stacked NV buffers of 1620x1920, the same crop; NV21, NV12,
   RGB, every stats mode, int and device tops) and odd frames; yuv2bgr
   (bit-exact, 1080p and odd heights); normalize ((3, 1080, 1920) f32 and
   u8, (3, 224, 224)); the warp kernel at BASELINE config 5's geometry
   (two 2560x1440 frames, the config-5 crop, its rotated matrix to
   1216x684; u8 bit-exact, f32 within 5e-3) and at 360x640 and 215x283
   over every interpolation, border, border value and type, four
   matrices, and the flags through ``warp_affine``; the correlation kernel
   against ``conv2d`` (TF32 off), within 1e-5 of the largest response, at
   four shapes; the tensor-core probe at every shape of
   benchmarks/probe_i8.py (bf16 and int8, 96x128x2048x64, the int8 K sweep,
   1024^3x32) and ragged ones, bit-exact on the probe's integer operands,
   random bf16 within 1e-5 of the largest sum of |a||b|;
4. main paths, each with the launch counters reset just before and read
   just after: config 4 (``Preprocessor.batch`` on three batches with a
   moving crop top held on the device), the fused NV camera path (the
   same, on NV21 buffers), the NV chain (a cubic NV config: yuv2bgr and
   normalize once per frame), config 2 (``cvt_color`` → CHW → f32),
   config 5 (``Preprocessor.batch`` on two batches of two 2560x1440
   frames with a device crop top: one warp launch per batch, one
   normalize per frame) and the tracking flow of
   ``examples/camera_tracking.py`` (six 720x1280 NV21 frames with a
   drifting 48x48 target: ``cvt_color`` → ``match_template`` →
   ``min_max_loc`` → a device top → the fused NV route; the target found
   within 2 px on every frame); each result is held against the plain
   PyTorch chain;
5. the harness path: the probe script as a user runs it
   (``vacv_tpu_torch.profile.probe_i8``: its rate, share of peak and a
   library call per shape, then the profiler's kernel time); ``CvProfile``
   over the five BASELINE configs at their own shapes, the port on the
   card against its plain chain on the CPU, every row at the 1e-4 bar;
   the SLAM front end of ``examples/slam_frontend.py`` (eight 720p frames
   through ``BatchLoader`` and ``to_device``, NV21 by the native host
   library, the NV21 and BGR Preprocessors on numpy input, back on cuda:0);
6. time: each kernel against its plain version (CUDA-event loop slopes
   of ``utils/perf.device_time``, in turns), its bound (bytes at 3.35
   TB/s or operations at the peak of their type) and one library call for
   the same function where PyTorch has one, and the main paths.

The last three lines are the kernels' JSON record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BATCH, H, W = 32, 1080, 1920
LEFT, TOP, CW, CH = 64, 28, 1792, 1036   # bench.py's crop
OUT = 224
HBM_TBPS = 3.35  # H100 SXM data sheet
NV_H = H * 3 // 2  # stacked NV buffer rows of a 1080p frame
STATIC = dict(mean=(104.0, 117.0, 123.0), stddev=(57.1, 57.4, 58.4))
# name → (source, the TPU kernel it replaces: file:line of its def)
KERNELS = {
    "preprocess_fused": ("vacv_tpu_torch/csrc/preprocess.cu",
                         "vacv_tpu/ops/pallas/preprocess.py:328"),
    "preprocess_fused_nv": ("vacv_tpu_torch/csrc/preprocess.cu",
                            "vacv_tpu/ops/pallas/preprocess.py:863"),
    "yuv2bgr": ("vacv_tpu_torch/csrc/yuv2bgr.cu", "vacv_tpu/ops/pallas/yuv2bgr.py:37"),
    "normalize_fused": ("vacv_tpu_torch/csrc/normalize.cu",
                        "vacv_tpu/ops/pallas/normalize.py:71"),
    "warp_affine": ("vacv_tpu_torch/csrc/warp_affine.cu",
                    "vacv_tpu/ops/pallas/warp_affine.py:365"),
    "match_corr": ("vacv_tpu_torch/csrc/match_template.cu",
                   "vacv_tpu/ops/pallas/match_template.py:71"),
    "probe_dot": ("vacv_tpu_torch/csrc/probe_mma.cu", "benchmarks/probe_i8.py:22"),
}
# BASELINE config 5 (benchmarks/baseline_configs.py:148-186): 2560x1440
# frames, crop (64, 36)-(2496, 1404), a rotated warp to 1216x684, 224 out,
# two frames per device.
H5, W5, BATCH5 = 1440, 2560, 2
RECT5 = (64, 36, 2496, 1404)
M5 = ((0.9, 0.03, 40.0), (-0.03, 0.9, 25.0))
WARP5 = (1216, 684)  # (w, h)
# The tracking flow of examples/camera_tracking.py.
TRACK_H, TRACK_W, TRACK_ROI, TARGET = 720, 1280, 320, 48
FP32_TFLOPS = 67.0  # H100 SXM data sheet, f32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {msg}")


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """The repo's cosine similarity (float64, on the host)."""
    from vacv_tpu_torch.utils.compare import cosine_similarity

    return cosine_similarity(a.cpu().numpy(), b.cpu().numpy())


def make_batch(n: int, h: int, w: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=g,
                         dtype=torch.uint8, device="cuda")


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch: {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {torch.cuda.get_device_name(0)}; "
        f"count {torch.cuda.device_count()}")
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build() -> None:
    from vacv_tpu_torch.ops.cuda import build

    b = build.library()
    how = f"built in {b.seconds:.1f} s" if b.log else "reused an earlier build"
    log(f"[build] {b.path.relative_to(build.BUILD_DIR.parent.parent)}: {how}")
    for line in b.log.splitlines():
        if "ptxas info" in line:
            log(f"[build]   {line.strip()}")


def check(label, got, want, kind) -> float:
    """Hold a kernel's output to its plain version's; returns max-abs.

    kind: "exact" (bit-exact), "lsb" (truncated u8 planes: <= 1 LSB on
    under 1e-3 of the values), "cos" (normalized fused output: cosine >=
    1-1e-6 and max-abs < 0.05), "norm" (standalone normalize: cosine >=
    1-1e-6, max-abs printed)."""
    torch.cuda.synchronize()
    require(got.shape == want.shape, f"{label}: shape {got.shape} vs {want.shape}")
    require(got.dtype == want.dtype, f"{label}: dtype {got.dtype} vs {want.dtype}")
    if kind == "exact":
        equal = torch.equal(got, want)
        log(f"[compare] {label}: bit-exact={equal}")
        require(equal, f"{label}: not bit-exact")
        return 0.0
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    d = (got - want).abs()
    max_abs = d.max().item()
    flips = (d > 0).double().mean().item()
    cos = cosine(got, want)
    log(f"[compare] {label}: max_abs={max_abs} flip_share={flips} "
        f"1-cos={1 - cos}")
    if kind == "lsb":
        require(max_abs <= 1.0 and flips < 1e-3, f"{label}: LSB bar")
    elif kind == "cos":
        require(cos >= 1 - 1e-6 and max_abs < 0.05, f"{label}: cosine bar")
    else:
        require(cos >= 1 - 1e-6, f"{label}: cosine bar")
    return max_abs


def compare(label, batch, rect, out, kind, **kw) -> float:
    """Config-4 kernel vs plain version on the same CUDA inputs."""
    from vacv_tpu_torch.ops.cuda.preprocess import (
        preprocess_fused_batch, preprocess_fused_batch_torch,
    )

    got = preprocess_fused_batch(batch, rect, out, **kw)
    torch.cuda.synchronize()
    return check(label, got, preprocess_fused_batch_torch(batch, rect, out, **kw), kind)


def compare_nv(label, nv, rect, out, kind, **kw) -> float:
    """NV kernel vs plain version on the same CUDA inputs."""
    from vacv_tpu_torch.ops.cuda.preprocess import (
        preprocess_fused_nv_batch, preprocess_fused_nv_batch_torch,
    )

    got = preprocess_fused_nv_batch(nv, rect, out, **kw)
    torch.cuda.synchronize()
    return check(label, got, preprocess_fused_nv_batch_torch(nv, rect, out, **kw), kind)


def make_nv(n: int, h: int, w: int, seed: int) -> torch.Tensor:
    """(n, h + ceil(h/2), w) stacked NV buffers: any bytes are valid."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.randint(0, 256, (n, h + (h + 1) // 2, w), generator=g,
                         dtype=torch.uint8, device="cuda")


def phase_compare() -> float:
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.ops.cuda.preprocess import preprocess_fused_batch

    rect = VRect(LEFT, TOP, LEFT + CW, TOP + CH)
    out = (OUT, OUT)
    batch = make_batch(BATCH, H, W, seed=0)
    head = compare(f"linear self-stats {BATCH}x{H}x{W}", batch, rect, out, "cos")
    static = dict(mean=(104.0, 117.0, 123.0), stddev=(57.1, 57.4, 58.4))
    compare("linear static stats", batch, rect, out, "cos", **static)
    compare("linear static mean, self stddev", batch, rect, out, "cos",
            mean=static["mean"])
    compare("linear normalize=False", batch, rect, out, "lsb", normalize=False)
    for interp in ("cubic", "nearest"):
        compare(f"{interp} self-stats", batch, rect, out, "cos", interp=interp)
        compare(f"{interp} normalize=False", batch, rect, out, "lsb",
                interp=interp, normalize=False)
    compare("top=40 (int)", batch, rect, out, "cos", top=40)
    top_dev = torch.tensor(40, dtype=torch.int32, device="cuda")
    compare("top=40 (device tensor)", batch, rect, out, "cos", top=top_dev)
    a = preprocess_fused_batch(batch, rect, out, top=40)
    b = preprocess_fused_batch(batch, rect, out, top=top_dev)
    require(torch.equal(a, b), "int top and device top differ")
    # Out of contract: a runtime top past H - ch is clamped in the kernel.
    far = torch.tensor(10_000, dtype=torch.int32, device="cuda")
    compare("top=10000 (device tensor, clamped)", batch, rect, out, "cos",
            top=far)
    c = preprocess_fused_batch(batch, rect, out, top=far)
    e = preprocess_fused_batch(batch, rect, out, top=H - CH)
    torch.cuda.synchronize()
    require(torch.equal(c, e), "far top is not clamped to H - ch")
    for h, w, r in [(144, 176, None), (214, 284, None),
                    (214, 284, VRect(10, 6, 270, 202))]:
        small = make_batch(BATCH, h, w, seed=h + w)
        compare(f"odd frame {h}x{w} crop {r}", small, r, out, "cos")
        compare(f"odd frame {h}x{w} crop {r} normalize=False", small, r, out,
                "lsb", normalize=False)
    del batch
    return head


def phase_compare_nv() -> float:
    """The NV fused kernel at full width: 32 stacked 1080p NV buffers."""
    from vacv_tpu_torch.core.types import VRect

    rect = VRect(LEFT, TOP, LEFT + CW, TOP + CH)
    out = (OUT, OUT)
    nv = make_nv(BATCH, H, W, seed=1)
    head = compare_nv(f"NV21 self-stats {BATCH}x{NV_H}x{W}", nv, rect, out, "cos")
    for is_nv12 in (False, True):
        for to_rgb in (False, True):
            name = f"NV{12 if is_nv12 else 21}{' to_rgb' if to_rgb else ''}"
            kw = dict(is_nv12=is_nv12, to_rgb=to_rgb)
            if is_nv12 or to_rgb:
                compare_nv(f"{name} self-stats", nv, rect, out, "cos", **kw)
            compare_nv(f"{name} normalize=False", nv, rect, out, "lsb", normalize=False, **kw)
    compare_nv("NV21 static stats", nv, rect, out, "cos", **STATIC)
    compare_nv("NV12 static mean, self stddev", nv, rect, out, "cos", is_nv12=True,
               mean=STATIC["mean"])
    compare_nv("NV21 top=41 (int)", nv, rect, out, "cos", top=41)
    top_dev = torch.tensor(41, dtype=torch.int32, device="cuda")
    compare_nv("NV21 top=41 (device tensor)", nv, rect, out, "cos", top=top_dev)
    from vacv_tpu_torch.ops.cuda.preprocess import preprocess_fused_nv_batch

    a = preprocess_fused_nv_batch(nv, rect, out, top=41)
    b = preprocess_fused_nv_batch(nv, rect, out, top=top_dev)
    far = torch.tensor(10_000, dtype=torch.int32, device="cuda")
    compare_nv("NV21 top=10000 (device tensor, clamped)", nv, rect, out, "cos", top=far)
    c = preprocess_fused_nv_batch(nv, rect, out, top=far)
    e = preprocess_fused_nv_batch(nv, rect, out, top=H - CH)
    torch.cuda.synchronize()
    require(torch.equal(a, b), "NV: int top and device top differ")
    require(torch.equal(c, e), "NV: far top is not clamped to H - ch")
    for h, w, r in [(144, 176, None), (214, 284, None),
                    (214, 284, VRect(11, 7, 271, 203))]:
        small = make_nv(BATCH, h, w, seed=h + w + 1)
        compare_nv(f"NV21 frame {h}x{w} crop {r}", small, r, out, "cos")
        compare_nv(f"NV12 frame {h}x{w} crop {r} normalize=False", small, r, out, "lsb",
                   is_nv12=True, normalize=False)
    return head


def phase_compare_yuv2bgr() -> float:
    """yuv2bgr bit-exact against its plain version, odd heights included."""
    from vacv_tpu_torch.ops.cuda.yuv2bgr import nv_to_bgr
    from vacv_tpu_torch.ops.cvt_color import nv_to_bgr_planes_torch

    for h, w in [(H, W), (H - 1, W), (215, 284)]:
        buf = make_nv(1, h, w, seed=h)[0]
        for is_nv12 in (False, True):
            got = torch.stack(nv_to_bgr(buf[:h], buf[h:], is_nv12=is_nv12))
            want = torch.stack(nv_to_bgr_planes_torch(buf[:h], buf[h:], is_nv12=is_nv12))
            check(f"yuv2bgr NV{12 if is_nv12 else 21} {h}x{w}", got, want, "exact")
    return 0.0


def phase_compare_normalize() -> float:
    """The standalone normalize kernel against normalize_torch."""
    from vacv_tpu_torch.core.image import Image
    from vacv_tpu_torch.core.types import Layout
    from vacv_tpu_torch.ops.cuda.normalize import normalize_fused
    from vacv_tpu_torch.ops.normalize import normalize_torch

    head = None
    for shape, dtype in [((3, H, W), torch.float32), ((3, H, W), torch.uint8),
                         ((3, OUT, OUT), torch.float32)]:
        g = torch.Generator(device="cuda")
        g.manual_seed(shape[1])
        x = torch.randint(0, 256, shape, generator=g, device="cuda").to(dtype)
        got = normalize_fused(x)
        want = normalize_torch(Image(x, Layout.CHW)).data
        err = check(f"normalize {dtype} {shape}", got, want, "norm")
        head = err if head is None else head
    return head


def warp_pair(planes, minv, h_out, w_out, **kw):
    """(flips, max-abs) of the warp kernel against its plain version on
    the same CUDA planes; u8 must be bit-exact, f32 within 5e-3."""
    from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch, warp_planes_batch_torch

    got = warp_planes_batch(planes, minv, h_out, w_out, **kw)
    want = warp_planes_batch_torch(planes, minv, h_out, w_out, **kw)
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype, f"warp {kw}: shape or type")
    d = (got.to(torch.float64) - want.to(torch.float64)).abs()
    flips, max_abs = int((d > 0).sum().item()), d.max().item()
    if got.dtype == torch.uint8:
        require(flips == 0, f"warp {tuple(planes.shape)} {kw}: {flips} u8 values differ")
    else:
        require(bool(torch.isfinite(got).all()) and max_abs <= 5e-3,
                f"warp {tuple(planes.shape)} {kw}: max_abs {max_abs}")
    return flips, max_abs


def phase_compare_warp() -> float:
    """The warp kernel at config 5's geometry, then a sweep of every
    interpolation, border, border value, type and four matrices at
    360x640 and 215x283, then the flags through ``warp_affine``."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch import config

    left, top, right, bottom = RECT5
    batch = make_batch(BATCH5, H5, W5, seed=50)
    crop = batch[:, top:bottom, left:right].permute(0, 3, 1, 2)  # a strided view
    minv = vt.invert_affine(np.asarray(M5, np.float32))
    worst = 0.0
    for dtype in (torch.uint8, torch.float32):
        flips, max_abs = warp_pair(crop.to(dtype), minv, WARP5[1], WARP5[0])
        log(f"[compare] warp config 5 {dtype} {BATCH5}x3x{bottom - top}x{right - left} -> "
            f"{WARP5[1]}x{WARP5[0]}: flipped values {flips}, max_abs={max_abs}")
        worst = max(worst, max_abs)
    del batch, crop
    for h, w in ((360, 640), (215, 283)):
        planes = make_batch(2, h, w, seed=h).permute(0, 3, 1, 2)
        h_out, w_out = h * 4 // 5, w * 4 // 5
        matrices = {
            "rotation": [[0.9, 0.03, 4.0], [-0.03, 0.9, 2.5]],
            "rot30": vt.get_rotation_matrix_2d(vt.VPoint(w / 2, h / 2), 30.0, 1.0),
            "axis_flip_scale": [[-1.25, 0.0, w * 1.1], [0.0, 0.75, 10.0]],
            "mostly_out": [[0.5, 0.0, w * 0.8], [0.0, 0.5, h * 0.8]],
        }
        for name, m in matrices.items():
            inv = vt.invert_affine(np.asarray(m, np.float32))
            runs, flips, max_abs = 0, 0, 0.0
            for dtype in (torch.uint8, torch.float32):
                src = planes.to(dtype)
                for interp in (vt.INTER_LINEAR, vt.INTER_NEAREST, vt.INTER_CUBIC):
                    for border in (vt.BORDER_CONSTANT, vt.BORDER_REPLICATE, vt.BORDER_REFLECT,
                                   vt.BORDER_WRAP, vt.BORDER_REFLECT_101):
                        for bv in (0.0, 17.0):
                            f, e = warp_pair(src, inv, h_out, w_out, interp=interp,
                                             border=border, border_value=bv)
                            runs, flips, max_abs = runs + 1, flips + f, max(max_abs, e)
            log(f"[compare] warp {h}x{w} {name}: {runs} interp x border x value x type "
                f"cases, u8 bit-exact, f32 max_abs={max_abs}")
    img = make_batch(1, 360, 640, seed=51)[0]
    m = np.asarray(matrices["rot30"], np.float32)
    flags = [
        ((m, (512, 288), vt.INTER_LINEAR, vt.BORDER_TRANSPARENT, 9.0), {}),
        ((m, (512, 288)), dict(edge_mode="vacv")),
        ((vt.invert_affine(m), (512, 288), int(vt.INTER_CUBIC) | int(vt.WARP_INVERSE_MAP)), {}),
        ((m, (512, 288), vt.INTER_NEAREST, int(vt.BORDER_REFLECT) | int(vt.BORDER_ISOLATED),
          vt.VScalar(3.0)), {}),
    ]
    for dtype in (torch.uint8, torch.float32, torch.float16):
        for args, kw in flags:
            got = vt.warp_affine(img.to(dtype), *args, **kw).data
            with config.backend("torch"):
                want = vt.warp_affine(img.to(dtype), *args, **kw).data
            torch.cuda.synchronize()
            require(torch.equal(got, want) if dtype == torch.uint8 else
                    (got.float() - want.float()).abs().max().item() <= 5e-3,
                    f"warp_affine flags {dtype} {args[2:]} {kw}")
    log("[compare] warp_affine flags (TRANSPARENT, vacv edge, WARP_INVERSE_MAP, ISOLATED, "
        "VScalar) on an HWC image, u8/f32/f16: held to the plain gather")
    return worst


def phase_compare_corr() -> float:
    """The correlation kernel against conv2d in f32 (TF32 off)."""
    from vacv_tpu_torch.ops.cuda.match_template import corr_planes, corr_planes_torch

    head = None
    for label, xs, ks, frac in [
        ("720x1280 u8-derived, 3 ch, 48x48", (3, 720, 1280), (3, 48, 48), False),
        ("360x640, 3 ch, 32x32", (3, 360, 640), (3, 32, 32), False),
        ("360x640 fractional f32, 3 ch, 24x20", (3, 360, 640), (3, 24, 20), True),
        ("720x1280, 1 ch, 7x129", (1, 720, 1280), (1, 7, 129), False),
    ]:
        g = torch.Generator(device="cuda")
        g.manual_seed(xs[1] + ks[2])
        if frac:
            x = torch.rand(xs, generator=g, device="cuda") * 2 - 1
            k = torch.rand(ks, generator=g, device="cuda") * 2 - 1
        else:
            x = torch.randint(0, 256, xs, generator=g, device="cuda").to(torch.float32)
            k = torch.randint(0, 256, ks, generator=g, device="cuda").to(torch.float32)
        got, want = corr_planes(x, k), corr_planes_torch(x, k)
        exact = torch.nn.functional.conv2d(x.double()[None], k.double()[None])[0, 0]
        torch.cuda.synchronize()
        require(got.shape == want.shape and bool(torch.isfinite(got).all()), f"corr {label}")
        scale = want.abs().max().item()
        max_abs = (got - want).abs().max().item()
        log(f"[compare] corr {label}: max_abs={max_abs} rel={max_abs / scale} "
            f"(vs f64: kernel {(got.double() - exact).abs().max().item() / scale}, "
            f"conv2d {(want.double() - exact).abs().max().item() / scale})")
        require(max_abs <= 1e-5 * scale, f"corr {label}: relative error {max_abs / scale}")
        head = max_abs if head is None else head
    return head


def phase_main_config5() -> dict:
    """BASELINE config 5: crop → one warp over the batch → per-frame
    resize → CHW f32 → normalize, the crop top moving on the device."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor

    pre = Preprocessor(PreprocessConfig(crop_rect=VRect(*RECT5), warp=(M5, WARP5),
                                        out_size=(OUT, OUT)), device="cuda")
    route = pre.describe_route((H5, W5, 3), torch.uint8)
    require(route == "cuda_warp", f"config 5 route is {route}")
    batches = [make_batch(BATCH5, H5, W5, seed=60 + i) for i in range(2)]
    tops = [torch.tensor(t, dtype=torch.int32, device="cuda") for t in (36, 30)]
    config.reset_kernel_counts()
    outs = [pre.batch(b, top=t) for b, t in zip(batches, tops)]
    torch.cuda.synchronize()
    names = ("warp_affine", "normalize_fused", "warp_affine_torch", "normalize_fused_torch")
    launches = {k: config.kernel_count(k) for k in names}
    log(f"[main] config 5 route={route} launches={launches} for 2 batches of {BATCH5}")
    require(launches == {"warp_affine": 2, "normalize_fused": 2 * BATCH5,
                         "warp_affine_torch": 0, "normalize_fused_torch": 0},
            f"config 5 launches {launches}")
    with config.backend("torch"):
        require(pre.describe_route((H5, W5, 3)) == "torch_chain", "torch backend, config 5")
        refs = [pre.batch(b, top=t) for b, t in zip(batches, tops)]
    hold_to_chain("config 5", outs, refs, (BATCH5, 3, OUT, OUT))
    return launches


def tracking_stream(n=6, h=TRACK_H, w=TRACK_W, seed=3):
    """n stacked NV21 frames (on the card) with a bright 48x48 target
    drifting down and right, the target (BGR u8, on the card) and its
    true (x, y) per frame; the NV21 encoding is the reference's Q14
    integer one (image_util.cpp:3-41)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (h, w, 3), dtype=np.uint8)
    target = rng.integers(180, 256, (TARGET, TARGET, 3), dtype=np.uint8)
    frames, truth = [], []
    for f in range(n):
        bgr = base.copy()
        ty, tx = 80 + 56 * f, 600 + 8 * f
        bgr[ty:ty + TARGET, tx:tx + TARGET] = target
        b, g, r = (bgr[..., i].astype(np.uint32) for i in range(3))
        y = (b * 1868 + g * 9617 + r * 4899) >> 14
        u = ((b[::2, ::2] - y[::2, ::2]) * np.uint32(9241) + np.uint32(128 << 14)) >> 14
        v = ((r[::2, ::2] - y[::2, ::2]) * np.uint32(11682) + np.uint32(128 << 14)) >> 14
        vu = np.empty((h // 2, w), np.uint8)
        vu[:, 0::2], vu[:, 1::2] = v.astype(np.uint8), u.astype(np.uint8)
        frames.append(torch.from_numpy(np.concatenate([y.astype(np.uint8), vu])).cuda())
        truth.append((tx, ty))
    return frames, torch.from_numpy(target).cuda(), truth


def tracking_pipeline():
    """One step of the tracking flow: (frame → (score, x, y, top, net
    input)), all on the device."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor

    pre = Preprocessor(PreprocessConfig(
        color_code=vt.COLOR_YUV2BGR_NV21, crop_rect=vt.VRect(0, 0, TRACK_W, TRACK_ROI),
        out_size=(OUT, OUT)), device="cuda")
    route = pre.describe_route((TRACK_H * 3 // 2, TRACK_W), torch.uint8)
    require(route == "cuda_fused_nv", f"tracking preprocess route is {route}")

    def step(nv, target):
        bgr = vt.cvt_color(nv, vt.COLOR_YUV2BGR_NV21)
        resp = vt.match_template(bgr, target, vt.TM_CCOEFF_NORMED)
        _, score, _, (x, y) = vt.min_max_loc(resp)
        top = torch.clamp(y - (TRACK_ROI - TARGET) // 2, 0, TRACK_H - TRACK_ROI)
        return score, x, y, top, pre.batch(nv[None], top=top)

    return step


def phase_main_tracking() -> dict:
    """The camera-tracking flow: six frames, counters reset just before."""
    from vacv_tpu_torch import config

    frames, target, truth = tracking_stream()
    step = tracking_pipeline()
    config.reset_kernel_counts()
    outs = [step(nv, target) for nv in frames]
    torch.cuda.synchronize()
    names = ("yuv2bgr", "match_corr", "preprocess_fused_nv")
    launches = {k: config.kernel_count(k) for k in names}
    log(f"[main] tracking launches={launches} for {len(frames)} frames")
    require(launches == dict.fromkeys(names, len(frames)), f"tracking launches {launches}")
    require(all(config.kernel_count(f"{k}_torch") == 0 for k in names),
            "tracking fell back to a plain version")
    with config.backend("torch"):
        refs = [step(nv, target) for nv in frames]
    for i, ((score, x, y, top, net), (tx, ty), ref) in enumerate(zip(outs, truth, refs)):
        log(f"[main] tracking frame {i}: target at ({x.item()}, {y.item()}), truth ({tx}, {ty}), "
            f"score={score.item():.4f}, roi top={top.item()}; plain chain "
            f"({ref[1].item()}, {ref[2].item()}) score={ref[0].item():.4f}")
        require(abs(x.item() - tx) <= 2 and abs(y.item() - ty) <= 2, "tracker lost the target")
        require(top.item() == ref[3].item(), "tracking top differs from the plain chain's")
        hold_to_chain(f"tracking frame {i}", [net], [ref[4]], (1, 3, OUT, OUT))
    return launches


def phase_main_path() -> int:
    from vacv_tpu_torch import config
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor

    pre = Preprocessor(PreprocessConfig(
        crop_rect=VRect(LEFT, TOP, LEFT + CW, TOP + CH),
        out_size=(OUT, OUT)), device="cuda")
    route = pre.describe_route((H, W, 3), torch.uint8)
    require(route == "cuda_fused", f"route is {route}")
    batches = [make_batch(BATCH, H, W, seed=10 + i) for i in range(3)]
    # A tracking camera: the ROI's top moves from batch to batch and is
    # known on the device.
    tops = [torch.tensor(t, dtype=torch.int32, device="cuda")
            for t in (28, 31, 35)]
    config.reset_kernel_counts()
    outs = [pre.batch(b, top=t) for b, t in zip(batches, tops)]
    torch.cuda.synchronize()
    launches = config.kernel_count("preprocess_fused")
    log(f"[main] route={route} preprocess_fused launches={launches}")
    require(launches == 3, f"kernel launched {launches} times, expected 3")
    with config.backend("torch"):
        require(pre.describe_route((H, W, 3), torch.uint8) == "torch_chain",
                "torch backend does not take the chain")
        refs = [pre.batch(b, top=t) for b, t in zip(batches, tops)]
    torch.cuda.synchronize()
    for i, (o, r) in enumerate(zip(outs, refs)):
        require(tuple(o.shape) == (BATCH, 3, OUT, OUT), f"shape {o.shape}")
        require(bool(torch.isfinite(o).all()), "non-finite output")
        cos, max_abs = cosine(o, r), (o - r).abs().max().item()
        log(f"[main] batch {i} top={tops[i].item()}: vs torch chain "
            f"1-cos={1 - cos} max_abs={max_abs}")
        require(cos >= 1 - 1e-6 and max_abs < 0.05, "main path vs chain")
    return launches


def hold_to_chain(label, outs, refs, shape) -> None:
    """Main-path outputs against the torch backend's chain."""
    for i, (o, r) in enumerate(zip(outs, refs)):
        require(tuple(o.shape) == shape, f"{label}: shape {o.shape}")
        require(bool(torch.isfinite(o).all()), f"{label}: non-finite output")
        cos, max_abs = cosine(o, r), (o - r).abs().max().item()
        log(f"[main] {label} batch {i}: vs torch chain 1-cos={1 - cos} max_abs={max_abs}")
        require(cos >= 1 - 1e-6 and max_abs < 0.05, f"{label}: main path vs chain")


def phase_main_nv() -> int:
    """The camera path: the fused NV route, crop top moving on the device."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.core.types import ColorCode, VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor

    pre = Preprocessor(PreprocessConfig(
        color_code=ColorCode.COLOR_YUV2BGR_NV21,
        crop_rect=VRect(LEFT, TOP, LEFT + CW, TOP + CH),
        out_size=(OUT, OUT)), device="cuda")
    route = pre.describe_route((NV_H, W), torch.uint8)
    require(route == "cuda_fused_nv", f"NV route is {route}")
    batches = [make_nv(BATCH, H, W, seed=20 + i) for i in range(3)]
    tops = [torch.tensor(t, dtype=torch.int32, device="cuda") for t in (28, 31, 35)]
    config.reset_kernel_counts()
    outs = [pre.batch(b, top=t) for b, t in zip(batches, tops)]
    torch.cuda.synchronize()
    launches = config.kernel_count("preprocess_fused_nv")
    log(f"[main] NV route={route} preprocess_fused_nv launches={launches}")
    require(launches == 3, f"NV kernel launched {launches} times, expected 3")
    with config.backend("torch"):
        refs = [pre.batch(b, top=t) for b, t in zip(batches, tops)]
    hold_to_chain("NV fused", outs, refs, (BATCH, 3, OUT, OUT))
    return launches


def phase_main_nv_chain() -> dict:
    """A cubic NV config: the chain, decoding and normalizing each frame
    through the yuv2bgr and normalize kernels."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.core.types import ColorCode, InterMode, VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor

    pre = Preprocessor(PreprocessConfig(
        color_code=ColorCode.COLOR_YUV2BGR_NV21,
        crop_rect=VRect(LEFT, TOP, LEFT + CW, TOP + CH),
        out_size=(OUT, OUT), interpolation=InterMode.INTER_CUBIC), device="cuda")
    route = pre.describe_route((NV_H, W), torch.uint8)
    require(route == "torch_chain", f"cubic NV route is {route}")
    nv = make_nv(BATCH, H, W, seed=30)
    top = torch.tensor(33, dtype=torch.int32, device="cuda")
    config.reset_kernel_counts()
    out = pre.batch(nv, top=top)
    torch.cuda.synchronize()
    launches = {k: config.kernel_count(k) for k in ("yuv2bgr", "normalize_fused")}
    log(f"[main] NV chain route={route} launches={launches} for {BATCH} frames")
    require(launches == {"yuv2bgr": BATCH, "normalize_fused": BATCH},
            f"chain launches {launches}, expected {BATCH} each")
    require(config.kernel_count("yuv2bgr_torch") == config.kernel_count("normalize_fused_torch")
            == 0, "the chain fell back to a plain version")
    with config.backend("torch"):
        ref = pre.batch(nv, top=top)
    hold_to_chain("NV cubic chain", [out], [ref], (BATCH, 3, OUT, OUT))
    return launches


def phase_main_config2() -> int:
    """BASELINE config 2: cvt_color(NV21) → CHW → f32 on the akiyo frame."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.core.types import ColorCode, Layout
    from vacv_tpu_torch.ops.cvt_color import cvt_color

    nv = make_nv(1, 144, 176, seed=40)[0]

    def config2():
        img = cvt_color(nv, ColorCode.COLOR_YUV2BGR_NV21)
        return img.change_layout(Layout.CHW).change_dtype(torch.float32).data

    config.reset_kernel_counts()
    out = config2()
    torch.cuda.synchronize()
    launches = config.kernel_count("yuv2bgr")
    log(f"[main] config 2 yuv2bgr launches={launches}")
    require(launches == 1, f"config 2 launched yuv2bgr {launches} times, expected 1")
    with config.backend("torch"):
        ref = config2()
    require(tuple(out.shape) == (3, 144, 176), f"config 2 shape {out.shape}")
    check("config 2 vs plain", out, ref, "exact")
    return launches


def ms_per_call(fn, iters: int) -> float:
    """Per-call time of ``fn()`` in ms: the CUDA-event loop slope of
    ``utils/perf.device_time``, ``iters`` calls against 2."""
    from vacv_tpu_torch.utils.perf import device_time

    return device_time(lambda i: fn(), iters=iters, base_iters=2) * 1e3


def timing(k_ms, p_ms, bound_ms, bound_by, library_ms=None) -> dict:
    """A kernel's times for the kernels line (plain floats for JSON)."""
    return dict(ms=float(k_ms), plain_ms=float(p_ms), bound_ms=float(bound_ms),
                bound_by=bound_by, library_ms=None if library_ms is None else float(library_ms))


def phase_time(card: str) -> dict:
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
    from vacv_tpu_torch.ops.cuda.preprocess import (
        _resize_weights, preprocess_fused_batch, preprocess_fused_batch_torch,
    )

    rect = VRect(LEFT, TOP, LEFT + CW, TOP + CH)
    batch = make_batch(BATCH, H, W, seed=0)
    k_ms, p_ms, kr, pr = time_in_turns(lambda: preprocess_fused_batch(batch, rect, (OUT, OUT)),
                                       lambda: preprocess_fused_batch_torch(batch, rect, (OUT, OUT)),
                                       50, 10)
    # Bytes the kernel has to move: the source rows that carry a tap,
    # across the crop's width, and the f32 planes written once.
    rows = int(np.count_nonzero(_resize_weights(CH, OUT, "linear").any(axis=0)))
    cols = int(np.count_nonzero(_resize_weights(CW, OUT, "linear").any(axis=0)))
    src_bytes = BATCH * rows * CW * 3
    out_bytes = BATCH * 3 * OUT * OUT * 4
    moved = src_bytes + out_bytes
    log(f"[time] taps touch {rows}/{CH} crop rows and {cols}/{CW} crop "
        f"columns; kernel must move {moved / 1e6:.1f} MB "
        f"(source {src_bytes / 1e6:.1f} MB + out {out_bytes / 1e6:.1f} MB; "
        f"whole crop {BATCH * CH * CW * 3 / 1e6:.1f} MB)")
    report(f"fused {BATCH}x{H}x{W}", k_ms, p_ms, kr, pr, moved, (BATCH, "frames"), card)
    # The main path as a user calls it, crop top on the device.
    pre = Preprocessor(PreprocessConfig(crop_rect=rect, out_size=(OUT, OUT)))
    top = torch.tensor(TOP, dtype=torch.int32, device="cuda")
    main_ms = ms_per_call(lambda: pre.batch(batch, top=top), 50)
    log(f"[time] main path Preprocessor.batch: {main_ms:.4f} ms/batch of "
        f"{BATCH}, {BATCH / main_ms * 1e3:.1f} frames/s [{card}]")
    return timing(k_ms, p_ms, moved / HBM_TBPS / 1e9, "bytes")


def time_in_turns(kern, plain, k_iters, p_iters):
    """(kernel ms, plain ms, kernel runs, plain runs) per call, CUDA-event
    loop slopes after warm-up, in turns: plain, kernel, kernel, plain."""
    for _ in range(3):
        kern()
        plain()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (ms_per_call(plain, p_iters), ms_per_call(kern, k_iters),
                      ms_per_call(kern, k_iters), ms_per_call(plain, p_iters))
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2), (p1, p2)


def report(label, k_ms, p_ms, k_runs, p_runs, moved, per, card) -> None:
    """One timing line for the kernel and one for its plain version.
    ``per`` is (count, unit) of one call, e.g. (32, "frames")."""
    for name, runs, ms in (("kernel", k_runs, k_ms), ("plain", p_runs, p_ms)):
        log(f"[time] {label} {name}: {ms:.4f} ms/call "
            f"(runs {runs[0]:.4f}, {runs[1]:.4f}), "
            f"{per[0] / ms * 1e3:.1f} {per[1]}/s, "
            f"{moved / ms / 1e6:.1f} GB/s = "
            f"{100 * moved / ms / 1e9 / HBM_TBPS:.2f}% of {HBM_TBPS} TB/s "
            f"[{card}]")


def phase_time_nv(card: str) -> dict:
    """The camera path's kernels against their plain versions, and the
    fused NV main path.  Returns {name: timing}."""
    from vacv_tpu_torch.core.image import Image
    from vacv_tpu_torch.core.types import ColorCode, Layout, VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
    from vacv_tpu_torch.ops.cuda.normalize import normalize_fused
    from vacv_tpu_torch.ops.cuda.preprocess import (
        _resize_weights, preprocess_fused_nv_batch, preprocess_fused_nv_batch_torch,
    )
    from vacv_tpu_torch.ops.cuda.yuv2bgr import nv_to_bgr
    from vacv_tpu_torch.ops.cvt_color import nv_to_bgr_planes_torch
    from vacv_tpu_torch.ops.normalize import normalize_torch

    times = {}
    rect = VRect(LEFT, TOP, LEFT + CW, TOP + CH)
    nv = make_nv(BATCH, H, W, seed=1)
    k_ms, p_ms, kr, pr = time_in_turns(
        lambda: preprocess_fused_nv_batch(nv, rect, (OUT, OUT)),
        lambda: preprocess_fused_nv_batch_torch(nv, rect, (OUT, OUT)), 50, 5)
    # Bytes the NV kernel has to move: the Y rows that carry a tap and the
    # chroma rows they map to, across the crop's width, and the f32
    # planes written once.
    rows = np.flatnonzero(_resize_weights(CH, OUT, "linear").any(axis=0)) + TOP
    crows = np.unique(rows // 2)
    src_bytes = BATCH * (rows.size + crows.size) * CW
    out_bytes = BATCH * 3 * OUT * OUT * 4
    moved = src_bytes + out_bytes
    log(f"[time] NV: taps touch {rows.size}/{CH} Y rows, which map to {crows.size} "
        f"chroma rows; kernel must move {moved / 1e6:.1f} MB (source "
        f"{src_bytes / 1e6:.1f} MB + out {out_bytes / 1e6:.1f} MB; whole NV crop "
        f"{BATCH * CH * CW * 1.5 / 1e6:.1f} MB)")
    report(f"NV fused {BATCH}x{NV_H}x{W}", k_ms, p_ms, kr, pr, moved, (BATCH, "frames"), card)
    times["preprocess_fused_nv"] = timing(k_ms, p_ms, moved / HBM_TBPS / 1e9, "bytes")

    buf = nv[0]
    y, vu = buf[:H], buf[H:]
    k_ms, p_ms, kr, pr = time_in_turns(lambda: nv_to_bgr(y, vu, is_nv12=False),
                                       lambda: nv_to_bgr_planes_torch(y, vu, is_nv12=False),
                                       200, 20)
    moved = H * W * 3 // 2 + 3 * H * W
    log(f"[time] yuv2bgr must move {moved / 1e6:.2f} MB (1.5 B/px in, 3 B/px out)")
    report(f"yuv2bgr {H}x{W}", k_ms, p_ms, kr, pr, moved, (1, "frames"), card)
    times["yuv2bgr"] = timing(k_ms, p_ms, moved / HBM_TBPS / 1e9, "bytes")

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    x = torch.randint(0, 256, (3, H, W), generator=g, device="cuda").to(torch.float32)
    k_ms, p_ms, kr, pr = time_in_turns(
        lambda: normalize_fused(x), lambda: normalize_torch(Image(x, Layout.CHW)), 100, 20)
    moved = 2 * x.numel() * 4  # the f32 planes read once and written once
    # One library call for the same standardisation per channel:
    # instance_norm, (x - mean) / sqrt(var + eps) with eps inside the root.
    lib_ms = ms_per_call(lambda: torch.nn.functional.instance_norm(x[None], eps=1e-12), 100)
    log(f"[time] normalize must move {moved / 1e6:.1f} MB (f32 in once, out once); "
        f"library instance_norm {lib_ms:.4f} ms/call")
    report(f"normalize f32 (3, {H}, {W})", k_ms, p_ms, kr, pr, moved, (1, "images"), card)
    times["normalize_fused"] = timing(k_ms, p_ms, moved / HBM_TBPS / 1e9, "bytes", lib_ms)

    pre = Preprocessor(PreprocessConfig(color_code=ColorCode.COLOR_YUV2BGR_NV21,
                                        crop_rect=rect, out_size=(OUT, OUT)))
    top = torch.tensor(TOP, dtype=torch.int32, device="cuda")
    main_ms = ms_per_call(lambda: pre.batch(nv, top=top), 50)
    log(f"[time] NV main path Preprocessor.batch: {main_ms:.4f} ms/batch of "
        f"{BATCH}, {BATCH / main_ms * 1e3:.1f} frames/s [{card}]")
    return times


def phase_time_warp_corr(card: str) -> dict:
    """The warp and correlation kernels against their plain versions, and
    the config-5 and tracking main paths.  Returns {name: timing}."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
    from vacv_tpu_torch.ops.cuda.match_template import corr_planes, corr_planes_torch
    from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch, warp_planes_batch_torch

    times = {}
    left, top, right, bottom = RECT5
    batch = make_batch(BATCH5, H5, W5, seed=70)
    crop = batch[:, top:bottom, left:right].permute(0, 3, 1, 2)
    minv = vt.invert_affine(np.asarray(M5, np.float32))
    (w_out, h_out), (ch, cw) = WARP5, (bottom - top, right - left)
    k_ms, p_ms, kr, pr = time_in_turns(
        lambda: warp_planes_batch(crop, minv, h_out, w_out),
        lambda: warp_planes_batch_torch(crop, minv, h_out, w_out), 100, 5)
    # Bytes the warp must move: the crop's pixels the output maps onto
    # (the bounding box of the mapped output corners, inside the crop),
    # 3 bytes each, and the u8 output once.
    cx = [minv[0, 0] * x + minv[0, 1] * y + minv[0, 2] for x in (0, w_out) for y in (0, h_out)]
    cy = [minv[1, 0] * x + minv[1, 1] * y + minv[1, 2] for x in (0, w_out) for y in (0, h_out)]
    src_px = ((min(max(cx), cw) - max(min(cx), 0)) * (min(max(cy), ch) - max(min(cy), 0)))
    moved = BATCH5 * (3 * src_px + 3 * h_out * w_out)
    # One library call for a bilinear affine warp: grid_sample (f32 only:
    # an f32 copy of the same planes, its grid built from the same matrix
    # before timing).
    xs = torch.arange(w_out, device="cuda", dtype=torch.float32)
    ys = torch.arange(h_out, device="cuda", dtype=torch.float32)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    sx = minv[0, 0] * gx + minv[0, 1] * gy + minv[0, 2]
    sy = minv[1, 0] * gx + minv[1, 1] * gy + minv[1, 2]
    grid = torch.stack([(2 * sx + 1) / cw - 1, (2 * sy + 1) / ch - 1], -1)
    grid = grid.expand(BATCH5, h_out, w_out, 2).contiguous()
    crop_f = crop.float().contiguous()
    lib_ms = ms_per_call(lambda: torch.nn.functional.grid_sample(
        crop_f, grid, mode="bilinear", padding_mode="zeros", align_corners=False), 100)
    log(f"[time] warp config 5: the output maps onto {src_px / (ch * cw) * 100:.1f}% of the "
        f"{ch}x{cw} crop; the kernel must move {moved / 1e6:.1f} MB (source "
        f"{BATCH5 * 3 * src_px / 1e6:.1f} MB + out {BATCH5 * 3 * h_out * w_out / 1e6:.1f} MB); "
        f"library grid_sample (f32) {lib_ms:.4f} ms/call")
    report(f"warp u8 config 5 {BATCH5}x3x{ch}x{cw} -> {h_out}x{w_out}", k_ms, p_ms, kr, pr,
           moved, (BATCH5, "frames"), card)
    times["warp_affine"] = timing(k_ms, p_ms, moved / HBM_TBPS / 1e9, "bytes", lib_ms)
    del batch, crop, crop_f, grid

    g = torch.Generator(device="cuda")
    g.manual_seed(71)
    x = torch.randint(0, 256, (3, TRACK_H, TRACK_W), generator=g, device="cuda").float()
    k = torch.randint(0, 256, (3, TARGET, TARGET), generator=g, device="cuda").float()
    k_ms, p_ms, kr, pr = time_in_turns(lambda: corr_planes(x, k),
                                       lambda: corr_planes_torch(x, k), 20, 5)
    lib_ms = ms_per_call(lambda: torch.nn.functional.conv2d(x[None], k[None]), 5)
    outs = (TRACK_H - TARGET + 1) * (TRACK_W - TARGET + 1)
    moved = (x.numel() + k.numel() + outs) * 4
    flops = 2 * outs * k.numel()
    log(f"[time] corr must move {moved / 1e6:.1f} MB and do {flops / 1e9:.2f} GFLOP; "
        f"kernel {flops / k_ms / 1e9:.2f} TFLOP/s = {100 * flops / k_ms / 1e9 / FP32_TFLOPS:.2f}% "
        f"of {FP32_TFLOPS} f32 TFLOP/s, plain {flops / p_ms / 1e9:.2f} TFLOP/s; library "
        f"conv2d {lib_ms:.4f} ms/call [{card}]")
    report(f"corr (3, {TRACK_H}, {TRACK_W}) x (3, {TARGET}, {TARGET})", k_ms, p_ms, kr, pr,
           moved, (1, "frames"), card)
    bound = max(flops / FP32_TFLOPS / 1e9, moved / HBM_TBPS / 1e9)
    times["match_corr"] = timing(k_ms, p_ms, bound, "operations", lib_ms)

    pre = Preprocessor(PreprocessConfig(crop_rect=VRect(*RECT5), warp=(M5, WARP5),
                                        out_size=(OUT, OUT)))
    batch = make_batch(BATCH5, H5, W5, seed=72)
    dev_top = torch.tensor(top, dtype=torch.int32, device="cuda")
    for name, run in (("static top", lambda: pre.batch(batch)),
                      ("device top", lambda: pre.batch(batch, top=dev_top))):
        run()
        main_ms = ms_per_call(run, 20)
        log(f"[time] config 5 main path Preprocessor.batch ({name}): {main_ms:.4f} ms/batch of "
            f"{BATCH5}, {BATCH5 / main_ms * 1e3:.1f} frames/s [{card}]")
    frames, target, _ = tracking_stream(n=2)
    step = tracking_pipeline()
    step(frames[0], target)
    track_ms = ms_per_call(lambda: step(frames[1], target), 20)
    log(f"[time] tracking main path (cvt_color, match_template, min_max_loc, fused NV "
        f"preprocess): {track_ms:.4f} ms/frame, {1e3 / track_ms:.1f} frames/s [{card}]")
    return times


# ---- the harness path: the tensor-core probe, CvProfile, the front end ----

def probe_operands(m, k, n, reps, dtype, seed):
    """The probe's integer operands (a in [-100, 100), b in [-2, 3))."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    a = torch.randint(-100, 100, (m + reps, k), generator=g, device="cuda").to(dtype)
    b = torch.randint(-2, 3, (k, n), generator=g, device="cuda").to(dtype)
    return a, b


def phase_compare_probe() -> float:
    """The probe kernel against its plain version at every shape of
    benchmarks/probe_i8.py, both types, bit-exact on the probe's integer
    operands (every partial sum an integer below 2^24); ragged shapes;
    random bf16 operands within 1e-5 of the largest sum of product
    magnitudes (f32 sums of K·reps products in another order than the
    f64 plain version; worst case K·reps·2^-24)."""
    from vacv_tpu_torch.ops.cuda.probe import probe_dot, probe_dot_torch

    shapes = [(96, 128, 2048, 64, dt) for dt in (torch.bfloat16, torch.int8)]
    shapes += [(96, k, 1024, 64, torch.int8) for k in (32, 64, 96, 128)]
    shapes += [(1024, 1024, 1024, 32, dt) for dt in (torch.bfloat16, torch.int8)]
    shapes += [(37, 64, 75, 5, dt) for dt in (torch.bfloat16, torch.int8)]
    shapes += [(17, 96, 9, 1, dt) for dt in (torch.bfloat16, torch.int8)]
    for i, (m, k, n, reps, dt) in enumerate(shapes):
        a, b = probe_operands(m, k, n, reps, dt, seed=80 + i)
        check(f"probe {m}x{k}x{n} reps={reps} {dt}", probe_dot(a, b, reps),
              probe_dot_torch(a, b, reps), "exact")
    g = torch.Generator(device="cuda")
    g.manual_seed(90)
    a = torch.randn(96 + 64, 128, generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(128, 2048, generator=g, device="cuda").to(torch.bfloat16)
    got, want = probe_dot(a, b, 64).double(), probe_dot_torch(a, b, 64).double()
    mag = probe_dot_torch(a.abs(), b.abs(), 64).double().max().item()
    err = (got - want).abs().max().item()
    log(f"[compare] probe random bf16 96x128x2048 reps=64: max_abs={err} = {err / mag:.3e} of "
        f"the largest sum of |a||b| ({mag:.1f})")
    require(bool(torch.isfinite(got).all()) and err <= 1e-5 * mag, "probe random bf16")
    return 0.0


def phase_main_probe(card: str) -> tuple[int, dict]:
    """The probe script as a user runs it (``python -m
    vacv_tpu_torch.profile.probe_i8``), counters reset just before; then
    the kernel's own device time from the profiler, and the plain version
    at the 1024³ bf16 shape, which the kernels line reports."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.ops.cuda.probe import probe_dot, probe_dot_torch
    from vacv_tpu_torch.profile import probe_i8
    from vacv_tpu_torch.utils.perf import profiler_trace

    config.reset_kernel_counts()
    results = probe_i8.main()
    torch.cuda.synchronize()
    launches = config.kernel_count("probe_dot")
    log(f"[main] probe script: {len(results)} cases, probe_dot launches={launches}, "
        f"probe_dot_torch launches={config.kernel_count('probe_dot_torch')}")
    require(launches > 0 and config.kernel_count("probe_dot_torch") == 0, "probe launches")
    require(all(r["ok"] is not False for r in results), "probe script check failed")
    for r in results:
        log(f"[time] probe {r['label']} {r['m']}x{r['k']}x{r['n']} reps={r['reps']}: "
            f"{r['us']:.3f} us/call, {r['rate'] * 1e-12:.2f} T/s = {100 * r['peak_share']:.2f}% "
            f"of peak, bound {r['bound_us']:.3f} us, library {r['library_us']:.3f} us [{card}]")
    # The kernel alone: the profiler's device time per launch, against the
    # event slope (which includes the host's launch cost where that is
    # longer than the kernel).
    for m, k, n, reps, dt in ((96, 128, 2048, 64, torch.bfloat16),
                              (96, 128, 2048, 64, torch.int8),
                              (1024, 1024, 1024, 32, torch.bfloat16)):
        a, b = probe_operands(m, k, n, reps, dt, seed=95)
        probe_dot(a, b, reps)
        torch.cuda.synchronize()
        with profiler_trace("build/probe_trace") as prof:
            for _ in range(20):
                probe_dot(a, b, reps)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if "probe_kernel" in e.key]
        total = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                    for e in dev)
        count = sum(e.count for e in dev)
        flops = 2 * m * k * n * reps
        if not count:
            log(f"[time] probe {m}x{k}x{n} reps={reps} {dt}: the profiler recorded no launch")
            continue
        per_us = total / count
        log(f"[time] probe {m}x{k}x{n} reps={reps} {dt}: profiler device time "
            f"{per_us:.3f} us/launch over {count} launches = "
            f"{flops / per_us * 1e-6:.2f} T/s [{card}]")
    big = next(r for r in results if r["label"] == "bf16 1024^3")
    a, b = probe_operands(1024, 1024, 1024, 32, torch.bfloat16, seed=96)
    p_ms = ms_per_call(lambda: probe_dot_torch(a, b, 32), 3)
    log(f"[time] probe plain version (float64) bf16 1024^3 reps=32: {p_ms:.4f} ms/call [{card}]")
    return launches, timing(big["us"] / 1e3, p_ms, big["bound_us"] / 1e3, "operations",
                            big["library_us"] / 1e3)


def harness_tests():
    """The five BASELINE configs (benchmarks/baseline_configs.py:53-186)
    as CvProfile tests: "ours" is the port on the card through its entry
    points, "ref" the port's plain torch chain on the CPU (the host role
    OpenCV plays in the reference; the card's host has no OpenCV
    requirement)."""
    import time

    import vacv_tpu_torch as vt
    from vacv_tpu_torch import config
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
    from vacv_tpu_torch.profile import TestFuncInfo
    from vacv_tpu_torch.utils.io import bgr2nv21_numpy
    from vacv_tpu_torch.utils.perf import device_time

    def img(h, w, seed):
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)

    def pair(fn, host, iters=8):
        dev = torch.from_numpy(host).cuda()

        def run():
            with config.backend("torch"), config.device("cpu"):
                t0 = time.perf_counter()
                ref = fn(torch.from_numpy(host))
                ref_ms = (time.perf_counter() - t0) * 1e3
            sec = device_time(lambda i, b: fn(b), dev, iters=iters, base_iters=2)
            out = fn(dev)
            require(out.device.type == "cuda" and bool(torch.isfinite(out).all()), "harness output")
            return [ref_ms, sec * 1e3, cosine(out, ref), 1.0]

        return run

    rect1 = vt.VRect(8, 6, 168, 138)
    ladder = [((224, 224), vt.INTER_LINEAR), ((512, 512), vt.INTER_CUBIC),
              ((1920, 1080), vt.INTER_LINEAR)]
    pre4 = Preprocessor(PreprocessConfig(crop_rect=vt.VRect(16, 8, 1264, 712), out_size=(224, 224)))
    pre5 = Preprocessor(PreprocessConfig(crop_rect=vt.VRect(*RECT5), warp=(M5, WARP5),
                                         out_size=(OUT, OUT)))

    def c1(b):
        return vt.resize(vt.crop(vt.Image(b), rect1), (128, 96)).data

    def c2(b):
        return vt.cvt_color(b, vt.COLOR_YUV2BGR_NV21).change_layout(vt.CHW).change_dtype(
            torch.float32).data

    def c3(b):
        f = vt.Image(b).change_dtype(torch.float32)
        return torch.cat([torch.cat(vt.mean_stddev(vt.resize(f, wh, interpolation=mode)))
                          for wh, mode in ladder])

    nv2 = bgr2nv21_numpy(img(144, 176, 22)).reshape(144 * 3 // 2, 176)
    return [
        TestFuncInfo("cfg1_crop_resize_qcif", pair(c1, img(144, 176, 11))),
        TestFuncInfo("cfg2_yuv_dtype_layout_qcif", pair(c2, nv2)),
        TestFuncInfo("cfg3_resize_ladder_stats", pair(c3, img(360, 640, 33))),
        TestFuncInfo("cfg4_fused_normalize_720p", pair(pre4, img(720, 1280, 44))),
        TestFuncInfo("cfg5_warp_pipeline", pair(pre5.batch, np.stack([img(H5, W5, 55)] * BATCH5),
                                                iters=6)),
    ]


def phase_harness(card: str) -> dict:
    """CvProfile over the five BASELINE configs; every row must pass at
    the 1e-4 bar, and the kernels of configs 2, 4 and 5 must have run."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.profile import CvProfile

    config.reset_kernel_counts()
    prof = CvProfile(k_test_times=2, k_log_batch_size=2)
    prof.profile(harness_tests(), verbose=True)
    torch.cuda.synchronize()
    names = ("yuv2bgr", "preprocess_fused", "warp_affine", "normalize_fused")
    launches = {k: config.kernel_count(k) for k in names}
    log(f"[harness] launches={launches} [{card}]")
    ok = prof.print_results()
    Path("build").mkdir(exist_ok=True)
    prof.save_results("build/harness_baseline_configs.json")
    require(ok, "a BASELINE config failed the 1e-4 bar")
    require(all(launches.values()), f"the harness did not run every kernel: {launches}")
    return launches


def phase_frontend(card: str) -> dict:
    """The flow of examples/slam_frontend.py on one card: eight synthetic
    720p frames written as PNGs and read back by ``BatchLoader`` (host
    batch and ``to_device``), NV21 synthesis by the native host library,
    then the NV21 Preprocessor on one buffer and on the batch, and the
    BGR batch from ``to_device`` through the fused BGR route; timed with
    ``utils/perf.time_fn`` and held against the plain chain."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch import config, native
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
    from vacv_tpu_torch.utils.io import bgr2nv21
    from vacv_tpu_torch.utils.loader import BatchLoader
    from vacv_tpu_torch.utils.perf import time_fn

    n, h, w = 8, 720, 1280
    rng = np.random.default_rng(0)
    folder = Path("build/frontend")
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        p = folder / f"frame{i}.png"
        p.write_bytes(vt.imencode(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), ".png"))
        paths.append(str(p))
    log(f"[frontend] native host library: available={native.available()} "
        f"jpeg={native.has_jpeg()} ({native.library_path().name})")
    require(native.available(), f"the native host library did not build: {native.build_error}")
    rect = vt.VRect(w // 8, h // 8, w - w // 8, h - h // 8)
    pre_nv = Preprocessor(PreprocessConfig(color_code=vt.COLOR_YUV2BGR_NV21, crop_rect=rect,
                                           out_size=(OUT, OUT)))
    pre_bgr = Preprocessor(PreprocessConfig(crop_rect=rect, out_size=(OUT, OUT)))
    require(pre_nv.describe_route((h * 3 // 2, w)) == "cuda_fused_nv", "frontend NV route")
    require(pre_bgr.describe_route((h, w, 3)) == "cuda_fused", "frontend BGR route")

    config.reset_kernel_counts()
    loader = BatchLoader(paths, batch_size=n, num_threads=4)
    host = next(iter(loader))
    dev = next(iter(loader.to_device()))
    nv_batch = np.stack([bgr2nv21(f).reshape(h * 3 // 2, w) for f in host])
    one = pre_nv(nv_batch[0])
    out_nv = pre_nv.batch(nv_batch)
    out_bgr = pre_bgr.batch(dev)
    torch.cuda.synchronize()
    require(all(o.device == torch.device("cuda", 0) for o in (one, out_nv, out_bgr)),
            "a numpy batch did not come back on cuda:0")
    names = ("native_bgr2nv21", "numpy_bgr2nv21", "preprocess_fused_nv", "preprocess_fused")
    launches = {k: config.kernel_count(k) for k in names}
    log(f"[main] frontend launches={launches} for {n} frames")
    require(dev.device.type == "cuda" and torch.equal(dev.cpu(), torch.from_numpy(host)),
            "to_device batch differs from the host batch")
    require(launches == {"native_bgr2nv21": n, "numpy_bgr2nv21": 0, "preprocess_fused_nv": 2,
                         "preprocess_fused": 1}, f"frontend launches {launches}")
    with config.backend("torch"):
        refs = [pre_nv(nv_batch[0])[None], pre_nv.batch(nv_batch), pre_bgr.batch(dev)]
    hold_to_chain("frontend NV one", [one[None]], refs[:1], (1, 3, OUT, OUT))
    hold_to_chain("frontend NV batch", [out_nv], refs[1:2], (n, 3, OUT, OUT))
    hold_to_chain("frontend BGR to_device", [out_bgr], refs[2:], (n, 3, OUT, OUT))
    log(f"[frontend] single-frame output: {tuple(one.shape)} mean={one.mean().item():.5f} "
        f"std={one.std().item():.4f}")
    best, mean, _ = time_fn(pre_nv.batch, nv_batch, iters=5, warmup=2)
    log(f"[time] frontend NV batch from numpy (copy to the card included): best {best:.3f} "
        f"mean {mean:.3f} ms/batch of {n} [{card}]")
    nv_dev = torch.from_numpy(nv_batch).cuda()
    best, mean, _ = time_fn(pre_nv.batch, nv_dev, iters=5, warmup=2)
    log(f"[time] frontend NV batch on the card: best {best:.3f} mean {mean:.3f} ms/batch of "
        f"{n} [{card}]")
    return launches


def main() -> int:
    card = phase_device()
    import vacv_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_build()
    errs = {
        "preprocess_fused": phase_compare(),
        "preprocess_fused_nv": phase_compare_nv(),
        "yuv2bgr": phase_compare_yuv2bgr(),
        "normalize_fused": phase_compare_normalize(),
        "warp_affine": phase_compare_warp(),
        "match_corr": phase_compare_corr(),
        "probe_dot": phase_compare_probe(),
    }
    # Each main path is driven with the counts set to 0 just before it
    # and read just after (inside each phase).
    launches = {"preprocess_fused": phase_main_path(), "preprocess_fused_nv": phase_main_nv()}
    chain = phase_main_nv_chain()
    launches["yuv2bgr"] = chain["yuv2bgr"] + phase_main_config2()
    launches["normalize_fused"] = chain["normalize_fused"]
    config5 = phase_main_config5()
    launches["warp_affine"] = config5["warp_affine"]
    launches["normalize_fused"] += config5["normalize_fused"]
    tracking = phase_main_tracking()
    launches["match_corr"] = tracking["match_corr"]
    launches["yuv2bgr"] += tracking["yuv2bgr"]
    launches["preprocess_fused_nv"] += tracking["preprocess_fused_nv"]
    launches["probe_dot"], probe_times = phase_main_probe(card)
    harness = phase_harness(card)
    for k in ("yuv2bgr", "preprocess_fused", "warp_affine", "normalize_fused"):
        launches[k] += harness[k]
    frontend = phase_frontend(card)
    launches["preprocess_fused"] += frontend["preprocess_fused"]
    launches["preprocess_fused_nv"] += frontend["preprocess_fused_nv"]
    times = {"preprocess_fused": phase_time(card), **phase_time_nv(card),
             **phase_time_warp_corr(card), "probe_dot": probe_times}
    record = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        **times[name],
    } for name, (source, replaces) in KERNELS.items()]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
