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
   ``-Xptxas -v`` lines, and the u8 linear warp kernels' registers and
   spills (``warp_kernel`` and its 3-channel HWC form) and the fused warp's
   (``moments_resize_kernel<WarpSource, ...>``) on lines of their own;
3. compare: every kernel against its plain PyTorch version on the card,
   at full width: the config-4 fused kernel (32 frames of 1080x1920, the
   BASELINE config-4 crop, 224x224 out) and odd frames, its moments form
   at 1, 8, 32 and 128 frames, linear, cubic and nearest,
   self, partial and static statistics (the normalize=False u8 planes bit
   for bit, the normalized output bit for bit against the host twin of the
   integer statistics over them); the NV fused
   kernel (32 stacked NV buffers of 1620x1920, the same crop; NV21, NV12,
   RGB, every stats mode, int and device tops) and odd frames, its
   one-pass form also bit for bit against the host twin of its statistics
   over the normalize=False output, against the two-launch form, the same
   bits on a second call and one launch a call, at the tracking ROI too;
   yuv2bgr (bit-exact at every vector width: 4K, 1080p, 720p, 144x176,
   widths 1928 and 284, tiny frames, odd heights, odd-offset and strided
   views);
   normalize ((3, 1080, 1920) and
   (3, 224, 224), then odd sizes: one element, h*w no multiple of 4, a
   prime, 64 planes, more planes than resident blocks, slices larger than
   shared memory; f32 and u8, from bases 0, 1 and 3 elements above a
   16-byte boundary, in both launch forms, the same bits on a second
   call); the warp kernel at BASELINE config 5's geometry (two 2560x1440
   frames, the config-5 crop as an HWC view, as planes and at an odd left,
   its rotated matrix to 1216x684), at 360x640 and 215x283 over every
   interpolation, border, border value and type and four matrices, over
   seeded fuzz matrices (rotate, scale, flip, overshoot past both edges)
   at sizes 1x1 to 360x640, every case through the kernel's three paths
   (staged, direct, edge) and bit-exact for u8 and f32, and the flags
   through ``warp_affine``; the warp reading config 5's crop at a device
   top (``row0``/``rows``: the uncut frames, tops inside, at 0, at the
   last start, negative and past the end, u8 and f32, HWC view and planes,
   bit for bit against the plain version on the cut planes, one launch a
   call); the correlation kernel
   against ``conv2d`` (TF32 off), within 1e-5 of the largest response, at
   seven shapes (the channel split, an HWC-strided image, outputs that are
   no multiple of the tile, 1x1 to 65x65 templates); the fused kernel on
   planar u8 planes (config 5's tail: the warp's output at 1, 2 and 8
   config-5 frames and random planes at config 5's size and odd sizes,
   every interpolation, self and static statistics: the u8 planes bit for
   bit or, where cuBLAS orders the plain version's sums otherwise, 1 LSB
   apart on the truncation step; self statistics bit for bit their integer
   statistics); the fused warp (``prepare_fused_warp``: config 5's warp
   sampled inside kernel #1's moments form) against the two-launch chain it
   replaces, bit for bit, at 2 and 16 config-5 frames, the config's crop and
   device tops inside and clamped, linear, cubic and nearest tails and a
   static mean, and the host twin of the integer statistics; the
   window-sum kernel against the ones-band products (720p x 48²: an HWC
   u8-valued image, random f32 planes, flat and low-variance images HWC
   and planar; and odd shapes; within 1e-5 of the largest sum, u8
   per-channel sums bit for bit) and all six match modes at 720p x 48²
   against the plain chain; the tensor-core probe
   at every shape of benchmarks/probe_i8.py (bf16 and int8,
   96x128x2048x64, the int8 K sweep, 1024^3x32), the split-reps path and
   ragged tile edges, bit-exact on the probe's integer operands and the
   same on a second run, random bf16 within 1e-5 of the largest sum of
   |a||b|;
4. main paths, each with the launch counters reset just before and read
   just after: config 4 (``Preprocessor.batch`` on three batches with a
   moving crop top held on the device), the fused NV camera path (the
   same, on NV21 buffers), the NV chain (a cubic NV config: yuv2bgr and
   normalize once per frame), config 2 (``cvt_color`` → CHW → f32),
   config 5 (``Preprocessor.batch`` on two batches of two 2560x1440
   frames with a device crop top: one fused warp call per batch, reading
   the uncut frames at that top, no warp, planar tail or normalize launch
   of its own) and the tracking flow of
   ``examples/camera_tracking.py`` (six 720x1280 NV21 frames with a
   drifting 48x48 target: ``cvt_color`` → ``match_template`` (one
   window-sum launch a frame) → ``min_max_loc`` → a device top → the
   fused NV route; the target found
   within 2 px on every frame); each result is held against the plain
   PyTorch chain;
5. the harness path: the probe script as a user runs it
   (``vacv_tpu_torch.profile.probe_i8``: its rate, share of peak and a
   library call per shape, then the profiler's device time of the kernels
   and of ``torch.matmul`` / ``torch._int_mm``); ``CvProfile``
   over the five BASELINE configs at their own shapes, the port on the
   card against its plain chain on the CPU, every row at the 1e-4 bar;
   the SLAM front end of ``examples/slam_frontend.py`` (eight 720p frames
   through ``BatchLoader`` and ``to_device``, NV21 by the native host
   library, the NV21 and BGR Preprocessors on numpy input, back on cuda:0);
   the serving layer (16 numpy 1080p frames through ``stream_map(pre,
   depth=4)`` and ``StreamExecutor(pre, depth=2)`` with the config-4
   Preprocessor: in order, bit for bit against ``pre(frame)`` one at a
   time, one launch a frame, then frames/s at depth 1 and 4 with the
   copies to the card; and ``stream_map(depth=4)`` over 96 crop and
   output shapes, three times the tap tables the cache holds, bit for bit
   against one stream); the scale-out layer (``make_mesh()``, an NCCL
   world of one: ``pre.batched(mesh)`` over the config-4 batch bit for
   bit against ``pre.batch`` in one launch, ``shard_batched_with_stats``
   over ``pre.fn`` with its all-reduced mean, ``entry()`` on cuda:0 in one
   launch, ``dryrun_multichip(1)``, host µs a call of ``batched`` against
   ``batch``); both examples' ``main()`` (``vacv_tpu_torch.examples``: the
   tracker within 2 px on every frame, the SLAM front end's sharded output
   bit for bit against ``pre.batch``); the group is destroyed after them;
6. time: each kernel against its plain version (CUDA-event loop slopes
   of ``utils/perf.device_time``, in turns), its bound (bytes at 3.35
   TB/s or operations at the peak of their type) and one library call for
   the same function where PyTorch has one (for the window sums, the
   ones-band GEMMs they replaced), and the main paths (event and host
   time); the profiler's device time per call of the correlation,
   ``conv2d``, ``grid_sample``, the window sums (and at strip heights
   from 16 to 232 rows, HWC and planar) and the GEMMs, of one
   tracking frame by kernel (no GEMM left, asserted) and of a config-5
   batch with no top, an int top and a device top by kernel (no gather
   with a device top, asserted); the planar tail's
   queued device time at 1 and 2 frames; the normalize
   kernel at (3, 1080, 1920) and (3, 224, 224), f32 and u8, and the warp
   kernel at config 5 (linear at 2 and 16 frames, cubic, nearest, planar,
   f32; the kernel each call launches, its ``warp.hwc3_launches`` and its
   tiles by path) with the kernels launched per call (one each, asserted),
   config 5's batch at 2 and 16 frames and
   the tracking frame by kernel, the fused warp against the two-launch
   chain at 2 and 16 config-5 frames (queued and profiler device time, in
   turns, beside the chain's bytes at 3.35 TB/s), yuv2bgr at 1080p, 720p
   and 144x176 (warm
   and with its source out of L2) and the fused NV kernel at the camera batch (self and static
   statistics) and the tracking frame (one launch each, asserted), the
   config-4 kernel's queued device time (``queued_us``) at 32 frames,
   linear, cubic and nearest, self and static statistics, its
   self-statistics launches by name (the resize to u8 and the scale, no
   launch reading the f32 planes back, asserted), the host cost of the
   cached tables' stream keys against ``record_stream``, the
   normalize kernel's two launch forms and the warp kernel's three paths
   side by side, the path every timed warp case took, yuv2bgr at every
   vector width over five frame sizes, and the NV one-pass form at every
   count of blocks a frame the card holds, beside its two-launch form, at
   1, 8, 32 and 128 frames.

``python3 chip_smoke.py --kernel-times`` runs the device and build phases
and the normalize, warp, config-5 (device, event and host enqueue time with
an int and a device top), tracking-frame, window-sum, yuv2bgr, fused NV and
config-4 timings alone, config 4 at 1, 8, 32 and 128 frames; a copy of
this script in an earlier checkout times that tree's kernels with the same
code.  ``python3 chip_smoke.py --parent DIR`` runs
the whole script and then ``--kernel-times`` in fresh processes, in DIR
(an unpacked ``git archive`` of an earlier commit, this script copied in)
and in this checkout, in turns (parent, change, change, parent), and
prints the two side by side, after comparing the two trees' kernel
libraries SASS for SASS (``cuobjdump -sass``: config 4's
``moments_resize_kernel<BgrSource, 2, 2>``, ``scale_u8_kernel`` and
``nv_one_pass_kernel`` must be the parent's).  ``python3 chip_smoke.py
--fused-warp [--parent DIR]`` runs the device and build phases, the fused
warp's compare and timing and, with ``--parent``, the SASS comparison
alone; ``--align [--parent DIR]`` the same for the alignment kernel
(``csrc/align.cu``: bit for bit the per-face ``warp_affine_normalize`` chain
and the plain version at ``align.resident``'s 16 1080p frames and ~190
faces, the ``Aligner``'s main path under three face counts, then its queued
and profiler time against the least bytes, a record's host time and the
per-face chain's time); the whole run does all of it too, and reports it
in the kernels line.

The last three lines are the kernels' JSON record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import re
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
    "warp_affine": ("vacv_tpu_torch/csrc/warp_affine.cuh",
                    "vacv_tpu/ops/pallas/warp_affine.py:365"),
    "match_corr": ("vacv_tpu_torch/csrc/match_template.cu",
                   "vacv_tpu/ops/pallas/match_template.py:71"),
    "probe_dot": ("vacv_tpu_torch/csrc/probe_mma.cu", "benchmarks/probe_i8.py:22"),
    # Kernel #1 on the warp's planar u8 output: config 5's tail.
    "preprocess_fused_planar": ("vacv_tpu_torch/csrc/preprocess.cu",
                                "vacv_tpu/ops/pallas/preprocess.py:328"),
    # No TPU kernel: the JAX box sums are XLA ones-band products.
    "window_sum": ("vacv_tpu_torch/csrc/window_sum.cu", "vacv_tpu/ops/match_template.py:37"),
    # Config 5 in one call: the warp sampled inside kernel #1's moments form.
    "preprocess_fused_warp": ("vacv_tpu_torch/csrc/preprocess_warp.cu",
                              "vacv_tpu/ops/pallas/warp_affine.py:365"),
    # No TPU kernel: every face of a batch in one launch, where vacv calls
    # warp_affine_normalize (a warp, then a normalize) once a face.
    "align_faces": ("vacv_tpu_torch/csrc/align.cu", "vacv_tpu/ops/fused.py:131"),
}
ALIGN_BATCH = 16  # align.resident's frames a batch
ARCFACE = ((127.5,) * 3, (127.5,) * 3)
# BASELINE config 5 (benchmarks/baseline_configs.py:148-186): 2560x1440
# frames, crop (64, 36)-(2496, 1404), a rotated warp to 1216x684, 224 out,
# two frames per device.
H5, W5, BATCH5 = 1440, 2560, 2
BATCH5_HOST = 16  # one 8-device host's batch: cfg5.resident's
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
    lines = b.log.splitlines()
    for line in lines:
        if "ptxas info" in line or "spill" in line:
            log(f"[build]   {line.strip()}")
    # The u8 linear warp kernels' and the fused warp's registers and spills, for PERF.md.
    for i, line in enumerate(lines):
        name = re.search(r"Function properties for (\w*warp_kernel(?:_hwc3|IhLi1E)\w*"
                         r"|\w*moments_resize_kernel\w*WarpSource\w*|\w*align_kernel\w*)", line)
        if name:
            used = next((x for x in lines[i + 2:i + 6] if "Used" in x), "")
            log(f"[build] {name.group(1)}: {lines[i + 1].strip()}; {used.split(':', 1)[-1].strip()}")


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
    return max(head, phase_compare_moments())


STATS_MODES = {"self": {}, "static mean, self stddev": dict(mean=STATIC["mean"]),
               "self mean, static stddev": dict(stddev=STATIC["stddev"]), "static": STATIC}


def phase_compare_moments() -> float:
    """The config-4 kernel's forms at the config-4 crop over 1, 8, 32 and
    128 frames, linear, cubic and nearest: the ``normalize=False`` u8
    planes bit for bit against the plain version; with self, partial and
    static statistics against the plain version (cosine >= 1-1e-6); the
    self and partial statistics (the moments form) bit for bit against the
    host twin of its integer statistics over the ``normalize=False``
    output; at odd frames and outputs too.  Returns the max-abs error against the plain version."""
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.ops.cuda import preprocess as pk

    rect, out = VRect(LEFT, TOP, LEFT + CW, TOP + CH), (OUT, OUT)
    worst = 0.0

    def twin(label, got, raw, kw):
        mu, inv = pk.one_pass_stats(raw, kw.get("mean"), kw.get("stddev"))
        require(torch.equal(got, (raw - mu[..., None, None]) * inv[..., None, None]),
                f"{label}: not its integer statistics over the normalize=False output")

    for n in (1, 8, BATCH, 128):
        batch = make_batch(n, H, W, seed=50 + n)
        for interp in ("linear", "cubic", "nearest"):
            label = f"config 4 {n}x{H}x{W} {interp}"
            plan = pk.launch_plan(n, OUT, OUT, pk.card_limits(0), source="bgr")
            require(plan.form == "moments", f"{label}: plan {plan}")
            raw = pk.preprocess_fused_batch(batch, rect, out, interp=interp, normalize=False)
            check(f"{label} normalize=False", raw,
                  pk.preprocess_fused_batch_torch(batch, rect, out, interp=interp,
                                                  normalize=False), "exact")
            for stats, kw in STATS_MODES.items():
                got = pk.preprocess_fused_batch(batch, rect, out, interp=interp, **kw)
                want = pk.preprocess_fused_batch_torch(batch, rect, out, interp=interp, **kw)
                worst = max(worst, check(f"{label} {stats}", got, want, "cos"))
                if stats != "static":
                    twin(f"{label} {stats}", got, raw, kw)
            log(f"[compare] {label}: the moments form bit for bit its integer statistics over "
                "the normalize=False output")
        del batch
    for h, w, r, o in [(144, 176, None, (176, 144)), (214, 284, VRect(10, 6, 270, 202), (99, 37)),
                       (2, 2, None, (5, 3)), (361, 641, VRect(1, 3, 640, 360), (97, 31))]:
        small = make_batch(3, h, w, seed=h + w + 5)
        for interp in ("linear", "cubic", "nearest"):
            label = f"config 4 odd 3x{h}x{w} crop {r} -> {o} {interp}"
            raw = pk.preprocess_fused_batch(small, r, o, interp=interp, normalize=False)
            got = pk.preprocess_fused_batch(small, r, o, interp=interp)
            worst = max(worst, check(label, got,
                                     pk.preprocess_fused_batch_torch(small, r, o, interp=interp),
                                     "cos"))
            twin(label, got, raw, {})
    log(f"[compare] config-4 forms: worst max_abs={worst} against the plain version")
    return worst


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
    return max(head, phase_compare_nv_one_pass(nv))


def check_one_pass(label, nv, rect, out, **kw) -> float:
    """The NV one-pass form against the plain version (cosine >= 1-1e-6,
    max-abs printed), bit for bit against the host twin of its statistics
    over the ``normalize=False`` output (its u8 values are those), against
    the forced two-launch form (cosine >= 1-1e-6) and the same bits on a
    second call (its one launch a call is asserted in ``kernel_times``).
    Returns the max-abs error."""
    from vacv_tpu_torch.ops.cuda import preprocess as pk

    plan = pk.launch_plan(nv.shape[0], out[1], out[0], pk.card_limits(0))
    require(plan.form == "one_pass", f"{label}: plan {plan}")
    got = pk.preprocess_fused_nv_batch(nv, rect, out, **kw)
    raw = pk.preprocess_fused_nv_batch(nv, rect, out, normalize=False, **kw)
    two = pk.preprocess_fused_nv_batch(nv, rect, out, form="two_launch", **kw)
    again = pk.preprocess_fused_nv_batch(nv, rect, out, **kw)
    err = check(f"{label} one-pass ({plan.blocks} blocks a frame)", got,
                pk.preprocess_fused_nv_batch_torch(nv, rect, out, **kw), "cos")
    mu, inv = pk.one_pass_stats(raw, kw.get("mean"), kw.get("stddev"))
    require(torch.equal(got, (raw - mu[..., None, None]) * inv[..., None, None]),
            f"{label}: one-pass output is not its statistics over the normalize=False output")
    cos2 = cosine(got, two)
    log(f"[compare] {label}: one-pass vs two-launch 1-cos={1 - cos2} "
        f"max_abs={(got - two).abs().max().item()}; u8 values = normalize=False output, "
        f"the same bits on a second call")
    require(cos2 >= 1 - 1e-6, f"{label}: one-pass vs two-launch")
    require(torch.equal(got, again), f"{label}: one-pass differs between two calls")
    return err


def phase_compare_nv_one_pass(nv) -> float:
    """The one-pass form at the camera main path's shape (NV21/NV12, BGR/RGB,
    self, static-mean-self-σ and self-mean-static-σ statistics, int and
    device tops), the tracking ROI and odd frames."""
    from vacv_tpu_torch.core.types import VRect

    rect, out = VRect(LEFT, TOP, LEFT + CW, TOP + CH), (OUT, OUT)
    worst = 0.0
    for is_nv12 in (False, True):
        for to_rgb in (False, True):
            for stats, kw in (("self", {}), ("static mean, self stddev", dict(mean=STATIC["mean"])),
                              ("self mean, static stddev", dict(stddev=STATIC["stddev"]))):
                name = f"NV{12 if is_nv12 else 21}{' to_rgb' if to_rgb else ''} {stats}"
                worst = max(worst, check_one_pass(name, nv, rect, out, is_nv12=is_nv12,
                                                  to_rgb=to_rgb, **kw))
    top_dev = torch.tensor(41, dtype=torch.int32, device="cuda")
    worst = max(worst, check_one_pass("NV21 top=41 (device tensor)", nv, rect, out, top=top_dev))
    frames, _, _ = tracking_stream(n=1)
    roi = VRect(0, 0, TRACK_W, TRACK_ROI)
    worst = max(worst, check_one_pass(f"tracking 1x{TRACK_H}x{TRACK_W} ROI {TRACK_W}x{TRACK_ROI}",
                                      frames[0][None], roi, out, top=200))
    for h, w, r, o in [(144, 176, None, (176, 144)), (214, 284, VRect(11, 7, 271, 203), out),
                       (2, 2, None, out), (360, 640, VRect(1, 3, 640, 360), (99, 37))]:
        small = make_nv(3, h, w, seed=h + w + 2)
        worst = max(worst, check_one_pass(f"NV21 frame {h}x{w} crop {r} -> {o}", small, r, o))
    log(f"[compare] NV one-pass: worst max_abs={worst} against the plain version")
    return worst


def nv_view(h, w, view, seed):
    """Y and VU planes of a stacked NV buffer on the card: "stacked",
    "odd_offset" (one byte above an aligned allocation) or "strided" (rows
    2048 bytes apart, or 8 past the width)."""
    rows = h + (h + 1) // 2
    pitch = {"stacked": w, "odd_offset": w, "strided": max(2048, w + 8)}[view]
    offset = 1 if view == "odd_offset" else 0
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    flat = torch.randint(0, 256, (rows * pitch + offset,), generator=g, dtype=torch.uint8,
                         device="cuda")
    buf = flat[offset:].view(rows, pitch)[:, :w]
    return buf[:h], buf[h:]


def phase_compare_yuv2bgr() -> float:
    """yuv2bgr bit-exact against its plain version at every vector width
    (8 at 4K, 1080p and a 1928 width; 4 at 720p and a 284 width; 2 at
    144x176, an odd base and tiny frames), odd heights and strided views."""
    from vacv_tpu_torch.ops.cuda.yuv2bgr import nv_to_bgr, vector_width
    from vacv_tpu_torch.ops.cvt_color import nv_to_bgr_planes_torch

    seen = {}
    for h, w in [(2 * H, 2 * W), (H, W), (H - 1, W), (TRACK_H, TRACK_W), (144, 176), (H - 1, 284),
                 (215, 284), (H, 1928), (3, 6), (1, 2)]:
        for view in ("stacked", "odd_offset", "strided"):
            y, vu = nv_view(h, w, view, seed=h + w)
            for is_nv12 in (False, True):
                planes = nv_to_bgr(y, vu, is_nv12=is_nv12)
                v = vector_width(h, w, y.data_ptr(), y.stride(0), vu.data_ptr(), vu.stride(0),
                                 planes[0].data_ptr())
                got = torch.stack(planes)
                want = torch.stack(nv_to_bgr_planes_torch(y, vu, is_nv12=is_nv12))
                check(f"yuv2bgr NV{12 if is_nv12 else 21} {h}x{w} {view} (stride {y.stride(0)}, "
                      f"{v} bytes a thread)", got, want, "exact")
                seen[v] = seen.get(v, 0) + 1
    log(f"[compare] yuv2bgr: cases by vector width {seen}, all bit-exact")
    require(set(seen) == {2, 4, 8}, f"yuv2bgr: not every vector width ran: {seen}")
    return 0.0


def phase_compare_normalize() -> float:
    """The standalone normalize kernel against normalize_torch: the main
    paths' shapes, then odd sizes (h*w no multiple of 4, one element, a
    prime, 64 planes, a plane just too large for a cluster, more planes
    than resident blocks, slices larger than shared memory), each from a
    16-byte-aligned base and from bases 1 and 3 elements above one (a
    contiguous slice at an odd offset), in both launch forms where the
    plane fits a cluster; the same bits on a second call."""
    from vacv_tpu_torch.core.image import Image
    from vacv_tpu_torch.core.types import Layout
    from vacv_tpu_torch.ops.cuda import normalize as nm
    from vacv_tpu_torch.ops.normalize import normalize_torch

    lim = nm._limits(0)
    log(f"[compare] normalize limits: {lim}")
    head, worst, cases = None, 0.0, 0
    shapes = [(3, H, W), (3, OUT, OUT), (1, 1, 1), (3, 37, 61), (2, 1, 65521), (64, 37, 64),
              (5, 13, 17), (2, 255, 257), (1, 300, 300), (7, 301, 303), (150, 260, 260),
              (2, 2160, 3840)]
    for shape in shapes:
        n = int(np.prod(shape))
        for dtype in (torch.float32, torch.uint8):
            plan = nm.launch_plan(shape[0], shape[1] * shape[2], 1 if dtype == torch.uint8 else 4, lim)
            forms = ("cluster", "grid") if plan.form == "cluster" else ("grid",)
            for offset in (0, 1, 3):
                g = torch.Generator(device="cuda")
                g.manual_seed(shape[1] + offset)
                buf = torch.randint(0, 256, (n + offset,), generator=g, device="cuda").to(dtype)
                x = buf[offset:].view(shape)   # contiguous, offset elements above the base
                want = normalize_torch(Image(x, Layout.CHW)).data
                for form in forms:
                    got = nm.normalize_fused(x, form=form)
                    torch.cuda.synchronize()
                    require(got.shape == want.shape and got.dtype == torch.float32
                            and bool(torch.isfinite(got).all()), f"normalize {shape} {dtype} {form}")
                    err = (got - want).abs().max().item()
                    cos = cosine(got, want) if n <= 3 * H * W else None
                    require(err < 1e-4 and (cos is None or cos >= 1 - 1e-6 or n == shape[0]),
                            f"normalize {shape} {dtype} {form} offset {offset}: max_abs {err} cos {cos}")
                    require(torch.equal(nm.normalize_fused(x, form=form), got),
                            f"normalize {shape} {dtype} {form}: differs between two calls")
                    if shape == (3, H, W) and dtype == torch.float32 and offset == 0:
                        head = err
                    worst, cases = max(worst, err), cases + 1
            log(f"[compare] normalize {str(dtype)[6:]} {shape}: plan {plan.form} "
                f"(cluster {plan.cluster}, grid {plan.grid}, slices a plane {plan.per_plane}, "
                f"held {plan.cap} of {plan.slice}, rounds {plan.rounds}); forms {forms} x offsets "
                f"0, 1, 3 held to the plain version")
    log(f"[compare] normalize: {cases} cases, worst max_abs={worst} (bar 1e-4, cosine >= 1-1e-6), "
        f"every case the same bits on a second call; (3, {H}, {W}) f32 max_abs={head}")
    return head


def warp_pair(planes, minv, h_out, w_out, **kw):
    """The warp kernel against its plain version on the same CUDA planes,
    through each of the kernel's paths ("auto": every tile chooses;
    "no_stage": no shared-memory copy of a tile's source box; "edge_only":
    every tap under the border rule): u8 and f32 both bit-exact.  Returns
    the number of comparisons made."""
    from vacv_tpu_torch.ops.cuda.warp_affine import PATHS, warp_planes_batch, warp_planes_batch_torch

    want = warp_planes_batch_torch(planes, minv, h_out, w_out, **kw)
    for path in PATHS:
        got = warp_planes_batch(planes, minv, h_out, w_out, path=path, **kw)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype, f"warp {kw}: shape or type")
        if not torch.equal(got, want):
            d = (got.to(torch.float64) - want.to(torch.float64)).abs()
            raise SystemExit(f"FAILED: warp {tuple(planes.shape)} strides {planes.stride()} "
                             f"{planes.dtype} {kw} path {path}: {int((d > 0).sum())} values differ, "
                             f"max_abs {d.max().item()}, matrix {np.asarray(minv).tolist()}")
    return len(PATHS)


def phase_compare_warp() -> float:
    """The warp kernel at config 5's geometry (every interpolation, two
    borders, the HWC crop view and planar planes, u8 and f32, and the crop
    at an odd left), then a sweep of every interpolation, border, border
    value, type and four matrices at 360x640 and 215x283, then seeded fuzz
    matrices (rotate, scale, flip, overshoot past both edges) on HWC views,
    planar planes and a crop at an odd left at sizes 1x1 to 360x640, then
    the flags through ``warp_affine``.  Every case runs through the
    kernel's three paths and is bit-exact to the plain version."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch import config
    from vacv_tpu_torch.ops.cuda.warp_affine import tile_paths
    from vacv_tpu_torch.utils.fuzz import affine_matrices

    borders = (vt.BORDER_CONSTANT, vt.BORDER_REPLICATE, vt.BORDER_REFLECT, vt.BORDER_WRAP,
               vt.BORDER_REFLECT_101)
    interps = (vt.INTER_LINEAR, vt.INTER_NEAREST, vt.INTER_CUBIC)
    left, top, right, bottom = RECT5
    batch = make_batch(BATCH5, H5, W5, seed=50)
    crop = batch[:, top:bottom, left:right].permute(0, 3, 1, 2)  # a strided view
    odd = batch[:, top:bottom, left + 1:right].permute(0, 3, 1, 2)
    minv = vt.invert_affine(np.asarray(M5, np.float32))
    runs = 0
    for name, src in (("HWC crop view u8", crop), ("planar u8", crop.contiguous()),
                      ("HWC f32", crop.float()), ("planar f32", crop.float().contiguous()),
                      ("HWC crop view u8, odd left", odd)):
        for interp in interps:
            for border in (vt.BORDER_CONSTANT, vt.BORDER_REFLECT_101):
                runs += warp_pair(src, minv, WARP5[1], WARP5[0], interp=interp, border=border,
                                  border_value=7.0)
            log(f"[compare] warp config 5 {name} {interp.name}: bit-exact on every path; tiles "
                f"{tile_paths(src, minv, WARP5[1], WARP5[0], interp)}")
    # A fuzz matrix at config 5's full size: steep maps put tiles over the
    # staging budget (the direct path) and on every edge.
    for i, m in enumerate(affine_matrices(5, bottom - top, right - left, WARP5[1], WARP5[0], 3)):
        for src in (crop, crop.float()):
            runs += warp_pair(src, m, WARP5[1], WARP5[0], interp=vt.INTER_CUBIC,
                              border=vt.BORDER_REFLECT)
            log(f"[compare] warp config 5 size, fuzz matrix {i} {src.dtype} cubic: bit-exact; "
                f"tiles {tile_paths(src, m, WARP5[1], WARP5[0], vt.INTER_CUBIC)}")
    del batch, crop, odd
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
            before = runs
            for dtype in (torch.uint8, torch.float32):
                src = planes.to(dtype)
                for interp in interps:
                    for border in borders:
                        for bv in (0.0, 17.0):
                            runs += warp_pair(src, inv, h_out, w_out, interp=interp,
                                              border=border, border_value=bv)
            log(f"[compare] warp {h}x{w} {name}: {runs - before} interp x border x value x type "
                f"x path cases, u8 and f32 bit-exact")
    paths = {"staged": 0, "direct": 0, "edge": 0}
    before = runs
    for h, w in ((1, 1), (2, 3), (5, 7), (37, 53), (215, 283), (360, 640)):
        img = make_batch(2, h, w + 1, seed=h + 7)
        img5 = torch.cat([img, img[..., :2]], dim=-1)  # five channels: two channel groups
        h_out, w_out = max(1, h * 4 // 5), max(1, w * 5 // 4)
        for m in affine_matrices(h * 1000 + w, h, w, h_out, w_out, 5):
            for src in (img[:, :, 1:].permute(0, 3, 1, 2),               # HWC, odd left
                        img5[:, :, :w].permute(0, 3, 1, 2).contiguous(),  # planar, 5 channels
                        img[:, :, :w].permute(0, 3, 1, 2).float()):       # HWC f32
                for interp in interps:
                    for border in borders:
                        runs += warp_pair(src, m, h_out, w_out, interp=interp, border=border,
                                          border_value=9.0)
                    for k, v in tile_paths(src, m, h_out, w_out, interp).items():
                        paths[k] += v
            runs += warp_pair(img[:, :, 1:].permute(0, 3, 1, 2), m, h_out, w_out,
                              edge_mode="vacv", border_value=3.0)
    log(f"[compare] warp fuzz (1x1 to 360x640, HWC at an odd left, planar x 5 channels, HWC f32; "
        f"every interpolation and border): {runs - before} cases bit-exact; tiles by path {paths}")
    require(all(paths.values()), f"the fuzz did not reach every path: {paths}")
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
            require(torch.equal(got, want) if dtype != torch.float16 else
                    (got.float() - want.float()).abs().max().item() <= 5e-3,
                    f"warp_affine flags {dtype} {args[2:]} {kw}")
    log("[compare] warp_affine flags (TRANSPARENT, vacv edge, WARP_INVERSE_MAP, ISOLATED, "
        "VScalar) on an HWC image, u8/f32/f16: held to the plain gather")
    log(f"[compare] warp: {runs} kernel-against-plain comparisons, all bit-exact")
    return 0.0


def phase_compare_warp_top() -> float:
    """The warp kernel reading the crop at a device top (``row0``/``rows``)
    at config 5's geometry: the uncut (1440-row) frames, the crop's 1368
    rows from a top inside the frame, at 0, at the last row it may start
    at, negative and past the end (clamped), u8 and f32, the HWC view and
    planes, bit for bit against the plain version on the planes cut at the
    clamped top, one ``warp_affine`` launch a call.  Returns 0.0 (the
    max-abs error, bit-exact)."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch import config
    from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch, warp_planes_batch_torch

    left, top, right, bottom = RECT5
    ch = bottom - top
    frames = make_batch(BATCH5, H5, W5, seed=75)[:, :, left:right]
    minv = vt.invert_affine(np.asarray(M5, np.float32))
    (w_out, h_out) = WARP5
    for dtype in (torch.uint8, torch.float32):
        view = frames.permute(0, 3, 1, 2).to(dtype)
        for layout, planes in (("HWC view", view), ("planes", view.contiguous())):
            for row0 in (top, 0, H5 - ch, -5, 400):
                t = torch.tensor(row0, dtype=torch.int32, device="cuda")
                config.reset_kernel_counts()
                got = warp_planes_batch(planes, minv, h_out, w_out, row0=t, rows=ch)
                torch.cuda.synchronize()
                label = f"warp device top {row0} {str(dtype)[6:]} {layout}"
                require(config.kernel_count("warp_affine") == 1, f"{label}: not one launch")
                at = min(max(row0, 0), H5 - ch)
                want = warp_planes_batch_torch(planes[:, :, at:at + ch], minv, h_out, w_out)
                require(torch.equal(got, want), f"{label}: differs from the plain version")
            log(f"[compare] warp device top {str(dtype)[6:]} {layout} {BATCH5}x3x{H5}x"
                f"{right - left} rows {ch} at tops {top}, 0, {H5 - ch}, -5, 400 (clamped): "
                f"bit-exact, one launch a call")
    return 0.0

def phase_compare_corr() -> float:
    """The correlation kernel against conv2d in f32 (TF32 off)."""
    from vacv_tpu_torch.ops.cuda.match_template import corr_planes, corr_planes_torch

    head = None
    for label, xs, ks, frac, hwc in [
        ("720x1280 u8-derived, 3 ch, 48x48 (channel split)", (3, 720, 1280), (3, 48, 48), False,
         True),
        ("360x640, 3 ch, 32x32", (3, 360, 640), (3, 32, 32), False, False),
        ("360x640 fractional f32, 3 ch, 24x20", (3, 360, 640), (3, 24, 20), True, False),
        ("720x1280, 1 ch, 7x129 (no split, six column chunks)", (1, 720, 1280), (1, 7, 129),
         False, False),
        ("300x500 HWC-strided, 5 ch, 48x48 (one channel a block)", (5, 300, 500), (5, 48, 48),
         False, True),
        ("97x161 fractional, 3 ch, 65x33 (outputs 33x129: tile edges)", (3, 97, 161),
         (3, 65, 33), True, False),
        ("100x300, 3 ch, 1x1", (3, 100, 300), (3, 1, 1), False, False),
    ]:
        g = torch.Generator(device="cuda")
        g.manual_seed(xs[1] + ks[2])
        if frac:
            x = torch.rand(xs, generator=g, device="cuda") * 2 - 1
            k = torch.rand(ks, generator=g, device="cuda") * 2 - 1
        else:
            x = torch.randint(0, 256, xs, generator=g, device="cuda").to(torch.float32)
            k = torch.randint(0, 256, ks, generator=g, device="cuda").to(torch.float32)
        if hwc:  # the planes of an interleaved image, as match_template passes them
            x = x.permute(1, 2, 0).contiguous().permute(2, 0, 1)
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


def config5_planes(n: int, seed: int) -> torch.Tensor:
    """The warp's (n, 3, 684, 1216) u8 output over n config-5 frames: what
    config 5's tail reads (black borders where the map leaves the crop)."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch

    left, top, right, bottom = RECT5
    crop = make_batch(n, H5, W5, seed)[:, top:bottom, left:right].permute(0, 3, 1, 2)
    minv = vt.invert_affine(np.asarray(M5, np.float32))
    return warp_planes_batch(crop, minv, WARP5[1], WARP5[0])


def check_planar_u8(label, got, planes, out, interp) -> None:
    """The planar kernel's ``normalize=False`` u8 planes against the plain
    version: bit for bit, or, where the plain version's dense products sum
    in another order than the kernel's taps (cuBLAS picks the order by
    shape), at most 1 LSB on under 1e-3 of the values, every flip on the
    truncation boundary: the float64 resample of that value lies within
    1e-4 of where clip(floor(x + eps)) steps."""
    from vacv_tpu_torch.ops.cuda import preprocess as pk
    from vacv_tpu_torch.ops.resize import u8_eps

    want = pk.preprocess_fused_planes_torch(planes, out, interp=interp, normalize=False)
    torch.cuda.synchronize()
    if torch.equal(got, want):
        log(f"[compare] {label}: bit-exact=True")
        return
    d = (got - want).abs()
    flips = d > 0
    wy, wx = (torch.from_numpy(pk._resize_weights(n, o, interp)).to("cuda", torch.float64)
              for n, o in ((planes.shape[-2], out[1]), (planes.shape[-1], out[0])))
    exact = torch.matmul(torch.matmul(wy, planes.double()), wx.T)[flips]
    edge = exact + u8_eps(pk.INTERP_MODES[interp])
    off = (edge - edge.round()).abs().max().item()
    log(f"[compare] {label}: {int(flips.sum())} values 1 LSB apart "
        f"({flips.double().mean().item():.2e}), each within {off:.2e} of the truncation step "
        "in float64 (the plain version's products sum in cuBLAS's order)")
    require(d.max().item() <= 1.0 and flips.double().mean().item() < 1e-3 and off < 1e-4,
            f"{label}: u8 planes off the boundary bar")


def phase_compare_planar() -> float:
    """The fused kernel on planar u8 planes (``preprocess_fused_planes``,
    config 5's tail) against its plain version: the warp's output at 1, 2
    and 8 config-5 frames, random planes at config 5's size and odd sizes,
    linear, cubic and nearest, self and static statistics: the
    ``normalize=False`` u8 planes bit for bit or on the truncation boundary
    (``check_planar_u8``), the normalized output at
    cosine >= 1-1e-6 (max-abs printed) and, with self statistics, bit for bit
    the host twin of its integer statistics over the u8 planes.  Returns
    the worst max-abs error."""
    from vacv_tpu_torch.ops.cuda import preprocess as pk

    worst, out = 0.0, (OUT, OUT)
    cases = [(f"config 5 warp output {n}x3x{WARP5[1]}x{WARP5[0]}", config5_planes(n, 150 + n), out)
             for n in (1, 2, 8)]
    g = torch.Generator(device="cuda")
    g.manual_seed(160)
    for n, h, w, o in ((2, WARP5[1], WARP5[0], out), (3, 37, 53, (61, 29)),
                       (1, 215, 283, (224, 224)), (2, 64, 112, (112, 64))):
        planes = torch.randint(0, 256, (n, 3, h, w), generator=g, dtype=torch.uint8, device="cuda")
        cases.append((f"random {n}x3x{h}x{w} -> {o[0]}x{o[1]}", planes, o))
    for label, planes, o in cases:
        for interp in ("linear", "cubic", "nearest"):
            raw = pk.preprocess_fused_planes(planes, o, interp=interp, normalize=False)
            check_planar_u8(f"planar {label} {interp} normalize=False", raw, planes, o, interp)
            for stats, kw in (("self", {}), ("static", STATIC)):
                got = pk.preprocess_fused_planes(planes, o, interp=interp, **kw)
                want = pk.preprocess_fused_planes_torch(planes, o, interp=interp, **kw)
                worst = max(worst, check(f"planar {label} {interp} {stats}", got, want, "cos"))
                if stats == "self":
                    mu, inv = pk.one_pass_stats(raw)
                    require(torch.equal(got, (raw - mu[..., None, None]) * inv[..., None, None]),
                            f"planar {label} {interp}: not its integer statistics")
    log(f"[compare] planar: worst max_abs={worst} against the plain version; self statistics "
        "bit for bit their integer statistics")
    return worst


def config5_source(batch, top=None):
    """Config 5's warp source in ``batch`` with ``top`` (None: the config's
    crop; a device int32: the uncut rows at that top, clamped): (planes,
    the inverse matrix, the warp's crop keywords)."""
    import vacv_tpu_torch as vt

    left, top0, right, bottom = RECT5
    minv = vt.invert_affine(np.asarray(M5, np.float32))
    if top is None:
        return batch[:, top0:bottom, left:right].permute(0, 3, 1, 2), minv, {}
    return batch[:, :, left:right].permute(0, 3, 1, 2), minv, dict(row0=top, rows=bottom - top0)


def fused_warp_pair(batch, interp="linear", top=None, **kw):
    """Config 5's fused warp (``prepare_fused_warp``, one call), the
    two-launch chain it replaces (the warp into planes, then the planar
    tail) and their plain version (``warp_planes_batch_torch``, then
    ``preprocess_fused_planes_torch``) on ``batch`` with ``top``
    (``config5_source``): (fused, chain, plain) as functions, and the
    fused call's truncated u8 planes (the head of its scratch, which each
    of its runs rewrites)."""
    from vacv_tpu_torch.ops.cuda import preprocess as pk
    from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch, warp_planes_batch_torch

    planes, minv, at = config5_source(batch, top)
    rec = pk.prepare_fused_warp(planes, minv, WARP5[1], WARP5[0], (OUT, OUT), interp=interp,
                                **at, **kw)
    require(rec is not None, "config 5 does not take the fused warp")
    n = planes.shape[0]

    def two(warp, tail):
        return lambda: tail(warp(planes, minv, WARP5[1], WARP5[0], **at), (OUT, OUT),
                            interp=interp, **kw)

    return (lambda: rec.run(planes, top), two(warp_planes_batch, pk.preprocess_fused_planes),
            two(warp_planes_batch_torch, pk.preprocess_fused_planes_torch),
            rec.held[-1][:n * 3 * OUT * OUT].view(n, 3, OUT, OUT))


def phase_compare_fused_warp() -> float:
    """The fused warp (``csrc/preprocess_warp.cu``) at config 5's geometry,
    2 and 16 frames, the config's crop and device tops inside, clamped
    below and above; linear, cubic and nearest tails; a static mean.  Held
    to the two-launch chain it replaces bit for bit (its output and its
    truncated u8 planes against the chain's ``normalize=False`` planes),
    and to the plain version: its u8 planes at ``check_planar_u8``'s bar
    over the plain warp's planes, its output at cosine >= 1-1e-6; with self
    statistics, bit for bit the host twin of the integer statistics over
    its planes.  Returns the worst max-abs error against the plain
    version."""
    from vacv_tpu_torch.ops.cuda import preprocess as pk
    from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch, warp_planes_batch_torch

    cases = [(n, interp, top, kw) for n in (BATCH5, BATCH5_HOST)
             for top in (None, 36, -5, 400) for interp, kw in (("linear", {}),)]
    cases += [(BATCH5, interp, 36, {}) for interp in ("cubic", "nearest")]
    cases += [(BATCH5, "linear", 36, dict(mean=STATIC["mean"]))]
    worst = 0.0
    for n, interp, top, kw in cases:
        batch = make_batch(n, H5, W5, seed=170 + n)
        t = None if top is None else torch.tensor(top, dtype=torch.int32, device="cuda")
        fused, chain, plain, u8 = fused_warp_pair(batch, interp, t, **kw)
        got, want = fused(), chain()
        torch.cuda.synchronize()
        label = f"fused warp config 5 {n} frames {interp} top {top} {kw or ''}"
        require(torch.equal(got, want), f"{label}: differs from the two-launch chain "
                f"(max abs {(got - want).abs().max().item()})")
        planes, minv, at = config5_source(batch, t)
        raw = pk.preprocess_fused_planes(warp_planes_batch(planes, minv, WARP5[1], WARP5[0], **at),
                                         (OUT, OUT), interp=interp, normalize=False)
        torch.cuda.synchronize()
        require(torch.equal(u8.float(), raw), f"{label}: u8 planes differ from the chain's")
        log(f"[compare] {label}: bit-exact against the two-launch chain (output and u8 planes)")
        check_planar_u8(f"{label} u8 planes against the plain version", u8.float(),
                        warp_planes_batch_torch(planes, minv, WARP5[1], WARP5[0], **at),
                        (OUT, OUT), interp)
        worst = max(worst, check(f"{label} against the plain version", got, plain(), "cos"))
        if not kw:
            mu, inv = pk.one_pass_stats(raw)
            require(torch.equal(got, (raw - mu[..., None, None]) * inv[..., None, None]),
                    f"{label}: not the integer statistics of its planes")
    log(f"[compare] fused warp: bit for bit the two-launch chain; worst max_abs={worst} "
        "against the plain version")
    return worst


def align_inputs(n: int, seed: int):
    """``align.resident``'s configuration, its chain, the face table of a
    batch of ``n`` frames (the chain's ``tops``: ~12 faces a frame, drawn
    frame by frame) and the frames, index and matrices on the card."""
    from portbench import manifest

    bench = manifest.load()
    cfg = manifest.config(bench, manifest.cell(bench, "align.resident"))
    chain = manifest.chain(cfg)
    table = chain.tops(cfg, n, seed, 0)
    return (cfg, chain, table, make_batch(n, H, W, seed), *chain.on_device(table, "cuda"))


def per_face_chain(frames, index, mats, mean, std, to_rgb):
    """vacv's ``warp_affine_normalize`` on each face's frame on the card, as
    (3, 112, 112) planes in output order: what the alignment kernel
    replaces."""
    import vacv_tpu_torch as vt

    m, s = (tuple(reversed(v)) for v in (mean, std)) if to_rgb else (mean, std)
    outs = []
    for k, f in enumerate(index.tolist()):
        chw = vt.warp_affine_normalize(frames[f], mats[k].cpu().numpy(), (112, 112), mean=m,
                                       stddev=s).data.permute(2, 0, 1)
        outs.append(chw.flip(0) if to_rgb else chw)
    return torch.stack(outs)


def phase_compare_align() -> float:
    """The alignment kernel (``csrc/align.cu``) at ``align.resident``'s
    shapes (16 1080p frames, ~190 faces from the chain's tables: boxes of 40
    to 400 px, rolls within 30 degrees, faces over the edges) and at 2
    frames; ArcFace's statistics in RGB and per-channel ones in BGR: bit for
    bit the per-face chain and the plain version on the card, one launch a
    call, and no launch for a batch of no faces.  Returns the max-abs gap
    to the plain version."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.ops.cuda.align import align_faces, align_faces_torch

    worst = 0.0
    for n, (mean, std), to_rgb in ((ALIGN_BATCH, ARCFACE, True),
                                   (ALIGN_BATCH, (STATIC["mean"], STATIC["stddev"]), False),
                                   (2, ARCFACE, True)):
        _, _, table, frames, index, mats = align_inputs(n, seed=190 + n + to_rgb)
        before = config.kernel_count("native.calls")
        got = align_faces(frames, index, mats, (112, 112), mean, std, to_rgb)
        torch.cuda.synchronize()
        label = f"alignment {n} frames {len(table.index)} faces {'rgb' if to_rgb else 'bgr'}"
        require(config.kernel_count("native.calls") == before + 1, f"{label}: not one launch")
        plain = align_faces_torch(frames, index, mats, (112, 112), mean, std, to_rgb)
        require(torch.equal(got, plain), f"{label}: differs from the plain version "
                f"(max abs {(got - plain).abs().max().item()})")
        chain = per_face_chain(frames, index, mats, mean, std, to_rgb)
        require(torch.equal(got, chain), f"{label}: differs from the per-face chain "
                f"(max abs {(got - chain).abs().max().item()})")
        worst = max(worst, float((got - plain).abs().max()))
        log(f"[compare] {label}: bit for bit the per-face chain and the plain version, one launch")
    frames = make_batch(2, H, W, seed=1)
    before = config.kernel_count("native.calls")
    empty = align_faces(frames, torch.zeros(0, dtype=torch.int32, device="cuda"),
                        torch.zeros((0, 2, 3), device="cuda"), (112, 112), *ARCFACE)
    require(empty.shape == (0, 3, 112, 112) and config.kernel_count("native.calls") == before,
            "alignment of no faces launched")
    log("[compare] alignment of no faces: an empty output, no launch")
    return worst


def phase_main_align() -> int:
    """Face alignment on its main path, ``models.Aligner.batch``, the counts
    set to 0 just before: one batch of 16 1080p frames under three face
    tables of the cell's draw (a K each), one launch of the alignment
    kernel a table, one launch record made and hit after, each output bit
    for bit the plain version on the card.  Returns the launches."""
    from portbench import manifest
    from vacv_tpu_torch import config
    from vacv_tpu_torch.models import Aligner
    from vacv_tpu_torch.ops.cuda.align import align_faces_torch

    bench = manifest.load()
    cfg = manifest.config(bench, manifest.cell(bench, "align.resident"))
    chain = manifest.chain(cfg)
    frames = make_batch(ALIGN_BATCH, H, W, seed=210)
    pool = chain.face_tables(cfg, ALIGN_BATCH, 24, 211, 0)
    every = chain.tables_on_device(pool, "cuda")
    tables, rois = zip(*((pool[t], every[t]) for t in (0, 8, 16)))  # three runs of counts
    aligner = Aligner(device="cuda")
    config.reset_kernel_counts()
    outs = [aligner.batch(frames, *r) for r in rois]
    torch.cuda.synchronize()
    names = ("align_faces", "align.batches", "align.records_made", "align.record_hits",
             "align_faces_torch")
    counts = {k: config.kernel_count(k) for k in names}
    ks = [len(t.index) for t in tables]
    log(f"[main] alignment of {ALIGN_BATCH} x 1080p under tables of {ks} faces: {counts}")
    require(counts == dict(zip(names, (3, 3, 1, 2, 0))), f"alignment counts {counts}")
    for k, ((index, mats), got) in enumerate(zip(rois, outs)):
        want = align_faces_torch(frames, index, mats, (112, 112), *ARCFACE, True)
        require(torch.equal(got, want), f"alignment table {k}: differs from the plain version")
    log("[main] alignment: one launch a table, one record for every face count, bit for bit "
        "the plain version")
    return counts["align_faces"]


def time_align(card: str) -> dict:
    """The alignment kernel at ``align.resident``'s shape (16 1080p frames,
    ~190 faces, ArcFace's input): queued device time (``queued_us``) and the
    profiler's kernel time against the batch's least bytes (the chain's
    ``table_bytes`` at 3.35 TB/s), a launch record's host time a call, and
    the per-face chain it replaces on the same batch (CUDA events)."""
    from vacv_tpu_torch.ops.cuda.align import align_faces_torch, prepare_align_faces

    cfg, chain, table, frames, index, mats = align_inputs(ALIGN_BATCH, seed=200)
    rec = prepare_align_faces(frames, index, mats, (112, 112), *ARCFACE, True)
    fn = lambda: rec.run(frames, index, mats)  # noqa: E731
    queued = [queued_us(fn) for _ in range(2)]
    total, kernels = device_profile(fn, 20)
    least = chain.table_bytes(cfg, table) / (HBM_TBPS * 1e12) * 1e6
    host = host_us(fn, 200)
    per_face = ms_per_call(lambda: per_face_chain(frames, index, mats, *ARCFACE, True), 3)
    plain = ms_per_call(lambda: align_faces_torch(frames, index, mats, (112, 112), *ARCFACE,
                                                  True), 5)
    k = len(table.index)
    log(f"[time] alignment {ALIGN_BATCH} x 1080p, {k} faces: queued device {queued[0]:.2f}, "
        f"{queued[1]:.2f} us a batch; profiler {total:.2f} us; least bytes "
        f"{chain.table_bytes(cfg, table) / 1e6:.2f} MB = {least:.2f} us at {HBM_TBPS} TB/s, "
        f"{100 * least / min(queued):.1f}% of the queued time; host {host:.2f} us a record "
        f"run; {ALIGN_BATCH / min(queued) * 1e6:.0f} frames/s on the card alone [{card}]")
    for name, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        log(f"[time]   alignment: {t:9.2f} us/batch  {c:g} launches/batch  {name[:110]}")
    log(f"[time] the per-face chain on the same batch: {per_face:.3f} ms "
        f"({ALIGN_BATCH / per_face * 1e3:.0f} frames/s); the plain version {plain:.3f} ms [{card}]")
    return timing(min(queued) / 1e3, plain, least / 1e3, "bytes", per_face)


def close_response(label, got, want, mode, x, k) -> float:
    """A match_template response against the plain chain's on the card, at
    the CPU tests' bars: NORMED modes within 1e-4; CCORR and CCOEFF within
    1e-5 of the largest response; SQDIFF within 1e-5 of the largest window
    sum of x^2 plus the template's (x, k: the (C, H, W) image and template).
    Returns the error over the bar's scale."""
    import vacv_tpu_torch as vt

    torch.cuda.synchronize()
    require(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{label}: shape")
    err = (got - want).abs().max().item()
    if mode in (vt.TM_SQDIFF_NORMED, vt.TM_CCORR_NORMED, vt.TM_CCOEFF_NORMED):
        scale, bar = 1.0, 1e-4
    elif mode == vt.TM_SQDIFF:
        sq = torch.nn.functional.avg_pool2d((x.double() ** 2).sum(0)[None, None], k.shape[1:],
                                            stride=1, divisor_override=1)
        scale, bar = sq.max().item() + (k.double() ** 2).sum().item(), 1e-5
    else:
        scale, bar = want.abs().max().item(), 1e-5
    log(f"[compare] {label} {mode.name}: max_abs={err} = {err / scale:.3e} of its scale")
    require(err <= bar * scale, f"{label} {mode.name}: {err} over {bar} x {scale}")
    return err / scale


def phase_compare_window_sum() -> float:
    """The window-sum kernel against its plain version (the ones-band
    products, TF32 off): Σ_c x² and the per-channel sums in one launch, at
    the tracking frame's 720p x 48² (the planes of an HWC u8-valued image,
    as match_template passes them; random f32 planes; flat and
    low-variance images, HWC and planar) and odd shapes (1x1, a window
    wider than one pass of 128 threads, full-width and full-height windows,
    2 and 5 channels, random f32),
    within 1e-5 of the largest sum, the per-channel sums of u8 values bit
    for bit; then all six modes of match_template at 720p x 48² against the
    plain chain.  Returns the max-abs error of Σ_c x² at 720p x 48²."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch import config
    from vacv_tpu_torch.ops.cuda.window_sum import window_sums, window_sums_torch

    head = None
    g = torch.Generator(device="cuda")
    g.manual_seed(170)
    full = (3, TRACK_H, TRACK_W, TARGET, TARGET)
    for c, h, w, th, tw, kind, hwc in (
            (*full, "u8", True), (*full, "f32", False), (*full, "flat", True),
            (*full, "flat", False), (*full, "low variance", True), (*full, "low variance", False),
            (1, 1, 1, 1, 1, "u8", False), (3, 97, 161, 65, 33, "u8", True),
            (2, 120, 300, 7, 129, "f32", False), (1, 40, 300, 40, 300, "u8", False),
            (3, 37, 61, 1, 61, "u8", True), (5, 64, 70, 64, 1, "f32", False)):
        frac = kind == "f32"
        if frac:
            x = torch.rand((c, h, w), generator=g, device="cuda") * 2 - 1
        elif kind == "flat":
            x = torch.full((c, h, w), 50.0, device="cuda")
        else:  # u8 values; of low variance: 100 or 101 (test_torch_match_template.py)
            lo, hi = (100, 102) if kind == "low variance" else (0, 256)
            x = torch.randint(lo, hi, (c, h, w), generator=g, device="cuda").to(torch.float32)
        if hwc:
            x = x.permute(1, 2, 0).contiguous().permute(2, 0, 1)
        kind += " HWC" if hwc else ""
        label = f"window sums {c}x{h}x{w} {th}x{tw} {kind}"
        config.reset_kernel_counts()
        sq, sums = window_sums(x, th, tw, sq=True, sums=True)
        torch.cuda.synchronize()
        require(config.kernel_count("window_sum") == 1, f"{label}: not one launch")
        want_sq, want_sums = window_sums_torch(x, th, tw, sq=True, sums=True)
        for name, got, want in (("sq", sq, want_sq), ("sums", sums, want_sums)):
            torch.cuda.synchronize()
            require(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{label} {name}")
            scale = max(want.abs().max().item(), 1e-30)
            err = (got - want).abs().max().item()
            log(f"[compare] {label} {name}: max_abs={err} = {err / scale:.3e} of the largest sum")
            require(err <= 1e-5 * scale, f"{label} {name}: {err / scale} of the largest sum")
            if name == "sq" and head is None:
                head = err
        if not frac:
            require(torch.equal(sums, want_sums), f"{label}: per-channel u8 sums not exact")
        require(torch.equal(window_sums(x, th, tw)[0], sq), f"{label}: sq alone differs")
    frames, target, _ = tracking_stream(n=1)
    bgr = vt.cvt_color(frames[0], vt.COLOR_YUV2BGR_NV21)
    x, k = (t.permute(2, 0, 1).to(torch.float32) for t in (bgr.data, target))
    for mode in (vt.TM_SQDIFF, vt.TM_SQDIFF_NORMED, vt.TM_CCORR, vt.TM_CCORR_NORMED,
                 vt.TM_CCOEFF, vt.TM_CCOEFF_NORMED):
        got = vt.match_template(bgr, target, mode).data
        with config.backend("torch"):
            want = vt.match_template(bgr, target, mode).data
        close_response(f"match_template {TRACK_H}x{TRACK_W} {TARGET}x{TARGET}", got, want, mode,
                       x, k)
    return head


def phase_main_config5() -> dict:
    """BASELINE config 5: crop → one warp over the batch → resize → CHW
    f32 → normalize of the whole warped batch, the crop top moving on the
    device; then the same with a static mean and stddev, a tail the fused
    warp does not take.  Returns the launches of both."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor

    batches = [make_batch(BATCH5, H5, W5, seed=60 + i) for i in range(2)]
    tops = [torch.tensor(t, dtype=torch.int32, device="cuda") for t in (36, 30)]
    names = ("preprocess_fused_warp", "warp_affine", "preprocess_fused_planar", "normalize_fused")
    total = dict.fromkeys(names, 0)
    # Per batch: with self statistics one fused warp call (the warp sampled
    # inside the planar tail's resize), no warp or planar launch of its own;
    # with static statistics the warp's launch, then the planar tail's.
    for label, kw, want in (
            ("config 5", {}, {"preprocess_fused_warp": 2}),
            ("config 5, static statistics", STATIC,
             {"warp_affine": 2, "preprocess_fused_planar": 2})):
        pre = Preprocessor(PreprocessConfig(crop_rect=VRect(*RECT5), warp=(M5, WARP5),
                                            out_size=(OUT, OUT), **kw), device="cuda")
        route = pre.describe_route((H5, W5, 3), torch.uint8)
        require(route == "cuda_warp", f"{label} route is {route}")
        config.reset_kernel_counts()
        outs = [pre.batch(b, top=t) for b, t in zip(batches, tops)]
        torch.cuda.synchronize()
        launches = {k: config.kernel_count(k) for k in names + tuple(f"{k}_torch" for k in names)}
        log(f"[main] {label} route={route} launches={launches} for 2 batches of {BATCH5}")
        require(launches == dict.fromkeys(launches, 0) | want, f"{label} launches {launches}")
        with config.backend("torch"):
            require(pre.describe_route((H5, W5, 3)) == "torch_chain", f"torch backend, {label}")
            refs = [pre.batch(b, top=t) for b, t in zip(batches, tops)]
        hold_to_chain(label, outs, refs, (BATCH5, 3, OUT, OUT))
        for k in names:
            total[k] += launches[k]
    return total


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
    names = ("yuv2bgr", "match_corr", "window_sum", "preprocess_fused_nv")
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


def device_us(fn, key=None, n=20):
    """The profiler's device time of ``fn()`` in µs per call: the kernels
    whose name contains ``key`` (every kernel when None), summed over
    ``n`` calls; None when the profiler recorded none of them."""
    from vacv_tpu_torch.utils.perf import profiler_trace

    fn()
    torch.cuda.synchronize()
    with profiler_trace("build/device_us") as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and (key is None or key in e.key)]
    total = sum(getattr(e, "device_time_total", 0) or 0 for e in kernels)
    return total / n if total else None


def device_profile(fn, n=20):
    """The profiler's view of ``fn()``: (device µs per call over every
    kernel, {kernel name: (device µs per call, launches per call)}) over
    ``n`` calls after one warm-up call.  The profiler now and then drops a
    launch's record (49 of 50), so a kernel's launches per call are its
    records over ``n`` rounded, and its time per call their mean time
    times that; a window in which it recorded no kernel at all is taken
    again (up to three times)."""
    from vacv_tpu_torch.utils.perf import profiler_trace

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profiler_trace("build/device_us") as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        if events:
            break
    kernels = {}
    for e in events:
        per_call = max(1, round(e.count / n))
        kernels[e.key] = ((getattr(e, "device_time_total", 0) or 0) / e.count * per_call, per_call)
    return sum(t for t, _ in kernels.values()), kernels


def queued_us(fn, reps=100):
    """Device µs per call of ``fn()`` with the host out of the way: the
    stream is held busy (``torch.cuda._sleep``) while the host enqueues
    ``reps`` calls, then two CUDA events time them back to back, launch
    gaps included; the median of three runs after a warm-up call.  (The
    profiler's sum over kernels counts a programmatic dependent launch from
    when its blocks start waiting.)"""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * reps * 150e-6))  # ~150 us of host time a call, at ~2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / reps * 1e3)
    return sorted(runs)[1]


NORMALIZE_KERNELS = ("normalize_", "partials_kernel", "merge_kernel", "scale_kernel")
CONFIG4_BATCHES = (1, 8, BATCH, 128)


kernel_names: dict = {}  # config-4 label -> the kernels the profiler saw


def kernel_times(card: str, config4_batches=(BATCH,)) -> dict:
    """The profiler's device time per call of the normalize kernel at the
    shapes the main paths and the table use, of the warp kernel at BASELINE
    config 5's geometry (2 frames, and linear at one host's 16), of one
    config-5 batch (2 and 16 frames) and one tracking frame by kernel, of
    yuv2bgr at
    1080p, 720p and 144x176 (warm, and with the source out of L2), of the
    fused NV kernel at the camera main path's batch (self and static
    statistics) and the tracking flow's frame, and the queued device time
    (``queued_us``) of the config-4 kernel at ``config4_batches`` frames,
    linear, cubic and nearest, self and static statistics.

    ``python3 chip_smoke.py --kernel-times`` runs the device and build
    phases and this alone, config 4 at 1, 8, 32 and 128 frames.  It calls only ``normalize_fused(x)``,
    ``warp_planes_batch(...)``, ``Preprocessor.batch``, ``nv_to_bgr``,
    ``preprocess_fused_nv_batch`` and ``preprocess_fused_batch`` with
    arguments that earlier versions of the port take too, so a copy of this
    script in an earlier checkout of the repo times that tree's kernels with
    the same code, in the same call on the same card.  Returns {label:
    (device µs per call, kernel launches per call)}; the kernels' names of
    each config-4 label go to ``kernel_names``."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
    from vacv_tpu_torch.ops.cuda.normalize import normalize_fused
    from vacv_tpu_torch.ops.cuda.preprocess import (
        preprocess_fused_batch, preprocess_fused_nv_batch,
    )
    from vacv_tpu_torch.ops.cuda.warp_affine import warp_planes_batch
    from vacv_tpu_torch.ops.cuda.window_sum import window_sums
    from vacv_tpu_torch.ops.cuda.yuv2bgr import nv_to_bgr

    out = {}

    def measure(label, fn, n=50):
        total, kernels = device_profile(fn, n)
        launches = sum(c for _, c in kernels.values())
        names = ", ".join(f"{k[:60]} {t:.2f} us x{c:g}" for k, (t, c) in sorted(kernels.items()))
        log(f"[time] {label}: {total:.2f} us device per call in {launches:g} launches "
            f"({names}) [{card}]")
        out[label] = (total, launches)

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    for shape in ((3, H, W), (3, OUT, OUT)):
        for dtype in (torch.float32, torch.uint8):
            x = torch.randint(0, 256, shape, generator=g, device="cuda").to(dtype)
            measure(f"normalize {str(dtype)[6:]} {shape}", lambda: normalize_fused(x))
    left, top, right, bottom = RECT5
    batch = make_batch(BATCH5, H5, W5, seed=70)
    crop = batch[:, top:bottom, left:right].permute(0, 3, 1, 2)
    minv = vt.invert_affine(np.asarray(M5, np.float32))
    (w_out, h_out) = WARP5

    def measure_warp(label, src, **kw):
        """``measure`` of ``warp_planes_batch(src, ...)``, with the form of
        the kernel the call takes and ``warp.hwc3_launches`` a call."""
        from vacv_tpu_torch.utils import trace

        measure(label, lambda: warp_planes_batch(src, minv, h_out, w_out, **kw))
        before = trace.counter("warp.hwc3_launches")
        warp_planes_batch(src, minv, h_out, w_out, **kw)
        log(f"[time]   {label}: {warp_form(src, kw.get('interp', vt.INTER_LINEAR))}, "
            f"warp.hwc3_launches +{trace.counter('warp.hwc3_launches') - before} a call, tiles "
            f"{warp_tiles(src, minv, h_out, w_out, kw)}")

    measure_warp("warp config 5 u8 linear CONSTANT", crop)
    out["host enqueue of the warp, config 5 u8 linear CONSTANT"] = (
        min(host_us(lambda: warp_planes_batch(crop, minv, h_out, w_out)) for _ in range(2)), 0)
    batch16 = make_batch(BATCH5_HOST, H5, W5, seed=71)
    crop16 = batch16[:, top:bottom, left:right].permute(0, 3, 1, 2)
    measure_warp(f"warp config 5 u8 linear CONSTANT, {BATCH5_HOST} frames", crop16)
    measure_warp("warp config 5 u8 cubic REFLECT_101", crop, interp=vt.INTER_CUBIC,
                 border=vt.BORDER_REFLECT_101)
    measure_warp("warp config 5 u8 nearest REPLICATE", crop, interp=vt.INTER_NEAREST,
                 border=vt.BORDER_REPLICATE)
    planar = crop.contiguous()
    measure_warp("warp config 5 u8 linear CONSTANT, planar source", planar)
    crop_f = crop.float()  # the view's strides are kept: HWC f32
    measure_warp("warp config 5 f32 linear CONSTANT", crop_f)
    del planar, crop_f

    pre = Preprocessor(PreprocessConfig(crop_rect=VRect(*RECT5), warp=(M5, WARP5),
                                        out_size=(OUT, OUT)))
    dev_top = torch.tensor(top, dtype=torch.int32, device="cuda")
    total, kernels = device_profile(lambda: pre.batch(batch, top=dev_top), 10)
    log(f"[time] config 5 main path: {total:.2f} us device per batch of {BATCH5} [{card}]")
    norm = sum(t for k, (t, _) in kernels.items() if any(s in k for s in NORMALIZE_KERNELS))
    warp = sum(t for k, (t, _) in kernels.items() if "warp_kernel" in k)
    planar = sum(t for k, (t, _) in kernels.items() if "PlanarSource" in k or "scale_u8" in k)
    fused = sum(t for k, (t, _) in kernels.items() if "WarpSource" in k)
    log(f"[time]   of which normalize {norm:.2f} us, warp {warp:.2f} us, planar tail "
        f"{planar:.2f} us (the scale launch included), fused warp {fused:.2f} us")
    for k, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[time]   {t:9.2f} us/batch {100 * t / total:5.1f}%  {c:g} launches/batch  {k[:120]}")
    out["config 5 main path"] = (total, sum(c for _, c in kernels.values()))
    out["config 5 normalize share"] = (norm, 0)
    out["config 5 warp share"] = (warp, 0)
    out["config 5 planar tail share"] = (planar, 0)
    out["config 5 fused warp share"] = (fused, 0)
    total, kernels = device_profile(lambda: pre.batch(batch16, top=dev_top), 10)
    warp = sum(t for k, (t, _) in kernels.items() if "warp_kernel" in k)
    log(f"[time] config 5 main path, {BATCH5_HOST} frames: {total:.2f} us device per batch, the "
        f"warp {warp:.2f} us [{card}]")
    out[f"config 5 main path, {BATCH5_HOST} frames"] = (total, sum(c for _, c in kernels.values()))
    out[f"config 5 warp share, {BATCH5_HOST} frames"] = (warp, 0)
    del batch16, crop16
    for name, run in (("int top", lambda: pre.batch(batch, top=top)),
                      ("device top", lambda: pre.batch(batch, top=dev_top))):
        total, kernels = device_profile(run, 10)
        out[f"config 5 {name}: device"] = (total, sum(c for _, c in kernels.values()))
        out[f"config 5 {name}: event"] = (ms_per_call(run, 20) * 1e3, 0)
        out[f"config 5 {name}: host enqueue"] = (min(host_us(run) for _ in range(2)), 0)
        log(f"[time] config 5 {name}: device {total:.2f} us, event "
            f"{out[f'config 5 {name}: event'][0]:.2f} us, host enqueue "
            f"{out[f'config 5 {name}: host enqueue'][0]:.1f} us a batch of {BATCH5} [{card}]")
    del batch, crop
    g = torch.Generator(device="cuda")
    g.manual_seed(73)
    x = torch.randint(0, 256, (TRACK_H, TRACK_W, 3), generator=g, device="cuda").float()
    x = x.permute(2, 0, 1)
    measure(f"window sums (3, {TRACK_H}, {TRACK_W}) HWC {TARGET}x{TARGET}, both sums",
            lambda: window_sums(x, TARGET, TARGET, sq=True, sums=True))
    measure(f"window sums (3, {TRACK_H}, {TRACK_W}) HWC {TARGET}x{TARGET}, sq only",
            lambda: window_sums(x, TARGET, TARGET))
    del x
    frames, target, _ = tracking_stream(n=2)
    step = tracking_pipeline()
    measure(f"tracking frame {TRACK_H}x{TRACK_W}, {TARGET}x{TARGET} target",
            lambda: step(frames[1], target), n=20)

    # The camera kernels: yuv2bgr on one frame, warm (back-to-back calls,
    # the source in L2) and with 96 MB written before each call (the source
    # out of the 50 MB L2); the fused NV kernel on the camera main path's
    # batch and on the tracking flow's one frame.
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def measure_cold(label, fn, key, n=20):
        def run():
            flush.zero_()
            return fn()

        _, kernels = device_profile(run, n)
        mine = [(t, c) for k, (t, c) in kernels.items() if key in k]
        total, launches = sum(t for t, _ in mine), sum(c for _, c in mine)
        log(f"[time] {label}: {total:.2f} us device per call in {launches:g} launches [{card}]")
        out[label] = (total, launches)

    for h, w in ((H, W), (TRACK_H, TRACK_W), (144, 176)):
        buf = make_nv(1, h, w, seed=h)[0]
        y, vu = buf[:h], buf[h:]
        measure(f"yuv2bgr {h}x{w}", lambda: nv_to_bgr(y, vu, is_nv12=False), n=100)
        measure_cold(f"yuv2bgr {h}x{w}, source out of L2", lambda: nv_to_bgr(y, vu, is_nv12=False),
                     "yuv2bgr")
    del flush
    rect = VRect(LEFT, TOP, LEFT + CW, TOP + CH)
    nv = make_nv(BATCH, H, W, seed=1)
    measure(f"NV21 fused {BATCH}x{H}x{W} -> {OUT}, self stats",
            lambda: preprocess_fused_nv_batch(nv, rect, (OUT, OUT)))
    measure(f"NV21 fused {BATCH}x{H}x{W} -> {OUT}, static stats",
            lambda: preprocess_fused_nv_batch(nv, rect, (OUT, OUT), **STATIC))
    frames, _, _ = tracking_stream(n=1)
    one, roi = frames[0][None], VRect(0, 0, TRACK_W, TRACK_ROI)
    top = torch.tensor(200, dtype=torch.int32, device="cuda")
    measure(f"NV21 fused tracking 1x{TRACK_H}x{TRACK_W}, ROI {TRACK_W}x{TRACK_ROI} -> {OUT}, "
            "self stats", lambda: preprocess_fused_nv_batch(one, roi, (OUT, OUT), top=top))
    del nv
    # The config-4 kernel at the config-4 crop: queued device time (the
    # profiler's sum double-counts a dependent launch) and the kernels.
    for n in config4_batches:
        batch = make_batch(n, H, W, seed=90 + n)
        for interp in ("linear", "cubic", "nearest"):
            for stats, kw in (("self", {}), ("static", STATIC)):
                label = f"config 4 {n}x{H}x{W} -> {OUT} {interp}, {stats} stats"

                def call():
                    return preprocess_fused_batch(batch, rect, (OUT, OUT), interp=interp, **kw)

                queued = queued_us(call)
                total, kernels = device_profile(call, 20)
                launches = sum(c for _, c in kernels.values())
                names = ", ".join(f"{(re.findall(r'\w+_kernel', k) or [k[:30]])[0]} {t:.2f} us x{c:g}"
                                  for k, (t, c) in sorted(kernels.items()))
                log(f"[time] {label}: {queued:.2f} us queued device time a call; profiler "
                    f"{total:.2f} us in {launches:g} launches ({names}) [{card}]")
                out[label] = (queued, launches)
                kernel_names[label] = sorted(kernels)
        del batch
    return out


def warp_form(src, interp) -> str:
    """The warp kernel a call on ``src`` launches (``hwc3_form``; a tree
    from before it has ``warp_kernel`` alone)."""
    from vacv_tpu_torch.ops.cuda import warp_affine as wk

    form = getattr(wk, "hwc3_form", None)
    return "warp_kernel_hwc3" if form is not None and form(src, interp) else "warp_kernel"


def warp_tiles(src, minv, h_out, w_out, kw) -> dict:
    """``tile_paths`` of a warp call (``kw``: its interpolation)."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch.ops.cuda.warp_affine import tile_paths

    return tile_paths(src, minv, h_out, w_out, kw.get("interp", vt.INTER_LINEAR))


def time_forms_and_paths(card: str) -> None:
    """What each design choice of the two redesigned kernels is worth, by
    the profiler's device time: the normalize kernel's two launch forms at
    (3, 224, 224), and the warp kernel at config 5 with every tile choosing
    its path, without the shared-memory copy, and with every tap under the
    border rule; and which path each timed warp case's tiles take."""
    import vacv_tpu_torch as vt
    from vacv_tpu_torch.ops.cuda.normalize import normalize_fused
    from vacv_tpu_torch.ops.cuda.warp_affine import PATHS, tile_paths, warp_planes_batch

    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    for dtype in (torch.float32, torch.uint8):
        x = torch.randint(0, 256, (3, OUT, OUT), generator=g, device="cuda").to(dtype)
        times = {form: device_profile(lambda: normalize_fused(x, form=form), 50)[0]
                 for form in ("cluster", "grid")}
        log(f"[time] normalize {str(dtype)[6:]} (3, {OUT}, {OUT}) by launch form: "
            + ", ".join(f"{k} {v:.2f} us" for k, v in times.items()) + f" [{card}]")
    left, top, right, bottom = RECT5
    batch = make_batch(BATCH5, H5, W5, seed=70)
    crop = batch[:, top:bottom, left:right].permute(0, 3, 1, 2)
    minv = vt.invert_affine(np.asarray(M5, np.float32))
    (w_out, h_out) = WARP5
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for name, src, kw in (
            ("u8 linear CONSTANT", crop, {}),
            ("u8 cubic REFLECT_101", crop, dict(interp=vt.INTER_CUBIC, border=vt.BORDER_REFLECT_101)),
            ("u8 linear CONSTANT, planar source", crop.contiguous(), {}),
            ("f32 linear CONSTANT", crop.float(), {})):
        times, cold = {}, {}
        for path in PATHS:
            def run():
                return warp_planes_batch(src, minv, h_out, w_out, path=path, **kw)

            def run_cold():  # 96 MB written first: the source is no longer in the 50 MB L2
                flush.zero_()
                return run()

            times[path] = device_profile(run, 30)[0]
            cold[path] = sum(t for k, (t, _) in device_profile(run_cold, 10)[1].items()
                             if "warp_kernel" in k)
        tiles = tile_paths(src, minv, h_out, w_out, kw.get("interp", vt.INTER_LINEAR))
        log(f"[time] warp config 5 {name}: {warp_form(src, kw.get('interp', vt.INTER_LINEAR))}, "
            f"tiles by path {tiles}; device time by path switch: "
            + ", ".join(f"{k} {v:.2f} us" for k, v in times.items()) + "; with the source out of "
            "L2: " + ", ".join(f"{k} {fmt_us(v or None)}" for k, v in cold.items()) + f" [{card}]")


def nv_one_pass_with(batch, rect, top, plan):
    """The fused NV kernel's one-pass form with ``plan``'s blocks a frame,
    through the wrapper's own record (the public call takes the plan's)."""
    from vacv_tpu_torch.ops.cuda import preprocess as pk

    geom = pk._nv_geometry(batch, rect, (OUT, OUT), top)
    return pk._prepare(batch, geom, (False, False), top, None, None, True, True, "linear",
                       "preprocess_fused_nv", plan=plan).run(batch, top)


def time_nv_one_pass_sweep(card: str) -> None:
    """The NV one-pass form at every count of blocks a frame the card
    holds at once, by the profiler's device time, beside the two-launch
    form: at 8, 32 and 128 frames of the camera main path's batch and at
    the tracking flow's one frame; every count gives the bits of the
    plan's."""
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.ops.cuda import preprocess as pk

    frames, _, _ = tracking_stream(n=1)
    rect = VRect(LEFT, TOP, LEFT + CW, TOP + CH)
    cases = [(f"tracking 1x{TRACK_H}x{TRACK_W} ROI {TRACK_W}x{TRACK_ROI} -> {OUT}",
              frames[0][None], VRect(0, 0, TRACK_W, TRACK_ROI), 200)]
    cases += [(f"{n}x{H}x{W} -> {OUT}", make_nv(n, H, W, seed=n), rect, None) for n in (8, 32, 128)]
    lim = pk.card_limits(0)
    for label, batch, rect, top in cases:
        n, times = batch.shape[0], {}
        ref = pk.preprocess_fused_nv_batch(batch, rect, (OUT, OUT), top=top)
        for c in pk._GRID_BLOCKS:
            plan = pk.one_pass_plan(n, OUT, OUT, lim, c)
            if plan is None:
                continue  # a grid barrier needs every block resident
            require(torch.equal(nv_one_pass_with(batch, rect, top, plan), ref),
                    f"NV one-pass {label}, {c} blocks: other bits than the plan's")
            times[f"{c} blocks"] = device_profile(
                lambda: nv_one_pass_with(batch, rect, top, plan), 30)[0]
        times["two-launch"] = device_profile(
            lambda: pk.preprocess_fused_nv_batch(batch, rect, (OUT, OUT), top=top, form="two_launch"),
            30)[0]
        auto = pk.launch_plan(n, OUT, OUT, lim)
        log(f"[time] NV one-pass sweep {label}: "
            + ", ".join(f"{k} {v:.2f} us" for k, v in times.items())
            + f"; the plan takes {auto.blocks} blocks, the fastest is {min(times, key=times.get)} "
            f"({lim}) [{card}]")
        del batch


def check_written_once(card: str) -> None:
    """The config-4 main path with self statistics writes its f32 planes
    once: its launches are the resize kernel (u8 planes) and the scale
    kernel, and no launch reads the f32 planes back (no normalize kernel),
    by the profiler's kernel names at 32 frames."""
    label = f"config 4 {BATCH}x{H}x{W} -> {OUT} linear, self stats"
    names = kernel_names[label]
    log(f"[time] {label}: kernels {[re.findall(r'\w+_kernel', k)[:1] for k in names]}")
    require(len(names) == 2 and any("moments_resize_kernel" in k for k in names)
            and any("scale_u8_kernel" in k for k in names)
            and not any("normalize" in k for k in names),
            f"{label}: the self-statistics path launches {names}")
    log("[time] config-4 self statistics: the f32 planes are written once (resize to u8, "
        "then scale), never read back")


def time_table_lookup(card: str) -> None:
    """What the cached device tables' stream repair costs the host, per
    fused call (two tables, four tensors): the stream-keyed lookup the port
    makes against a lookup keyed by shape alone, and against that lookup
    plus ``record_stream`` on each tensor (the other repair)."""
    import functools
    import time

    from vacv_tpu_torch.ops.cuda.preprocess import _device_taps

    dev = torch.device("cuda", 0)
    unkeyed = functools.lru_cache(maxsize=64)(lambda *a: _device_taps(*a))

    def keyed():
        _device_taps(CH, OUT, "linear", dev)
        _device_taps(CW, OUT, "linear", dev)

    def plain():
        unkeyed(CH, OUT, "linear", dev)
        unkeyed(CW, OUT, "linear", dev)

    def recorded():
        stream = torch.cuda.current_stream(dev)
        for t in (*unkeyed(CH, OUT, "linear", dev), *unkeyed(CW, OUT, "linear", dev)):
            t.record_stream(stream)

    def host_us(fn, n=20000):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    us = {name: [host_us(fn) for _ in range(2)] for name, fn in
          (("keyed by stream", keyed), ("keyed by shape", plain),
           ("keyed by shape + record_stream", recorded))}
    log("[time] device tables a fused call (host us): "
        + "; ".join(f"{k} {v[0]:.2f}, {v[1]:.2f}" for k, v in us.items()) + f" [{card}]")


def time_yuv2bgr_widths(card: str) -> None:
    """yuv2bgr at every vector width a stacked frame's layout allows, by the
    profiler's device time, at config 2's 144x176, CIF, VGA, the tracking
    frame, 1080p and 4K, beside the width ``vector_width`` picks; every
    width gives the same bits."""
    from vacv_tpu_torch.ops.cuda import build
    from vacv_tpu_torch.ops.cuda import yuv2bgr as yk

    fn = build.entry("vacv_yuv2bgr")
    for h, w in ((144, 176), (288, 352), (480, 640), (TRACK_H, TRACK_W), (H, W), (2 * H, 2 * W)):
        buf = make_nv(1, h, w, seed=h)[0]
        y, vu = buf[:h], buf[h:]
        want = torch.stack(yk.nv_to_bgr(y, vu, is_nv12=False))
        times = {}
        for v in (8, 4, 2):
            out = torch.empty((3, h, w), dtype=torch.uint8, device="cuda")
            if any(x % v for x in (w, h * w, y.data_ptr(), vu.data_ptr(), out.data_ptr())):
                continue

            def run(v=v, out=out):
                stream = torch.cuda.current_stream().cuda_stream
                build.call(fn, (0, stream, y.data_ptr(), w, vu.data_ptr(), w, out.data_ptr(), h, w,
                                0, v), f"yuv2bgr at {v} bytes a thread")
                return out

            require(torch.equal(run(), want), f"yuv2bgr {h}x{w} at {v} bytes: other bits")
            times[v] = device_profile(run, 100)[0]
        pick = yk.vector_width(h, w, y.data_ptr(), w, vu.data_ptr(), w, want.data_ptr())
        log(f"[time] yuv2bgr {h}x{w} by bytes a thread: "
            + ", ".join(f"{v} {t:.2f} us" for v, t in times.items())
            + f"; vector_width picks {pick}, the fastest is {min(times, key=times.get)} [{card}]")


def fmt_us(us) -> str:
    return "not recorded" if us is None else f"{us:.2f} us"


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
    """The warp, correlation, window-sum and planar kernels against their
    plain versions, and the config-5 and tracking main paths (device, event
    and host time).  Returns {name: timing}."""
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

    def library():
        return torch.nn.functional.grid_sample(crop_f, grid, mode="bilinear",
                                               padding_mode="zeros", align_corners=False)

    lib_ms = ms_per_call(library, 100)
    log(f"[time] warp config 5 profiler device time per call: kernel "
        f"{fmt_us(device_us(lambda: warp_planes_batch(crop, minv, h_out, w_out)))}, library "
        f"grid_sample {fmt_us(device_us(library))} [{card}]")
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
    corr_dev = device_us(lambda: corr_planes(x, k))
    log(f"[time] corr profiler device time per call {fmt_us(corr_dev)} (corr_kernel "
        f"{fmt_us(device_us(lambda: corr_planes(x, k), 'corr_kernel'))}, split_sum "
        f"{fmt_us(device_us(lambda: corr_planes(x, k), 'split_sum'))}); library conv2d "
        f"{fmt_us(device_us(lambda: torch.nn.functional.conv2d(x[None], k[None]), n=3))} "
        f"[{card}]")
    bound = max(flops / FP32_TFLOPS / 1e9, moved / HBM_TBPS / 1e9)
    times["match_corr"] = timing(k_ms, p_ms, bound, "operations", lib_ms)
    times["window_sum"] = time_window_sum(card)
    times["preprocess_fused_planar"] = time_planar(card)

    pre = Preprocessor(PreprocessConfig(crop_rect=VRect(*RECT5), warp=(M5, WARP5),
                                        out_size=(OUT, OUT)))
    batch = make_batch(BATCH5, H5, W5, seed=72)
    dev_top = torch.tensor(top, dtype=torch.int32, device="cuda")
    for name, run in (("static top", lambda: pre.batch(batch)),
                      ("int top", lambda: pre.batch(batch, top=top)),
                      ("device top", lambda: pre.batch(batch, top=dev_top))):
        run()
        main_ms = ms_per_call(run, 20)
        host = [host_us(run) for _ in range(2)]
        total, kernels = device_profile(run, 10)
        log(f"[time] config 5 main path Preprocessor.batch ({name}): {main_ms:.4f} ms/batch of "
            f"{BATCH5}, {BATCH5 / main_ms * 1e3:.1f} frames/s; host {host[0]:.1f}, {host[1]:.1f} "
            f"us/batch (enqueue); profiler device time {total:.2f} us/batch in "
            f"{sum(c for _, c in kernels.values()):g} launches [{card}]")
        for k, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
            log(f"[time]   {t:9.2f} us/batch {100 * t / total:5.1f}%  {c:g} launches/batch  "
                f"{k[:100]}")
        if name == "device top":  # the warp reads the crop at the top: no gather copies it
            gathers = [k for k in kernels if "index" in k.lower() or "gather" in k.lower()]
            require(not gathers, f"config 5 with a device top ran a gather: {gathers}")
            log(f"[time]   no gather in a config-5 batch with a device top "
                f"({len(kernels)} kernels)")
    frames, target, _ = tracking_stream(n=2)
    step = tracking_pipeline()
    step(frames[0], target)
    track_ms = ms_per_call(lambda: step(frames[1], target), 20)
    host = [host_us(lambda: step(frames[1], target)) for _ in range(2)]
    log(f"[time] tracking main path (cvt_color, match_template, min_max_loc, fused NV "
        f"preprocess): {track_ms:.4f} ms/frame, {1e3 / track_ms:.1f} frames/s; host "
        f"{host[0]:.1f}, {host[1]:.1f} us/frame (enqueue) [{card}]")
    tracking_breakdown(lambda: step(frames[1], target), card)
    return times


def host_us(fn, n=50) -> float:
    """Host µs per call of ``fn()``: the enqueue, n calls on the host clock
    after a warm-up call, the card synchronised before and after."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def time_window_sum(card: str) -> dict:
    """The window-sum kernel at the tracking frame (Σ_c x² and the
    per-channel sums of a (3, 720, 1280) HWC u8-valued image over 48 x 48
    windows, one launch) against its plain version, its bound and the
    ones-band GEMMs it replaced (the library column): event slopes in
    turns, and the profiler's device time of each."""
    from vacv_tpu_torch.ops.cuda.window_sum import (
        _box_sum, _launch, launch_plan, window_sums, window_sums_torch,
    )

    g = torch.Generator(device="cuda")
    g.manual_seed(73)
    x = torch.randint(0, 256, (TRACK_H, TRACK_W, 3), generator=g, device="cuda").float()
    x = x.permute(2, 0, 1)  # the planes of an HWC image, as match_template passes them
    q = (x * x).sum(0)

    def kernel():
        return window_sums(x, TARGET, TARGET, sq=True, sums=True)

    def gemms():  # the four ones-band GEMMs the tracking frame ran before this kernel
        return _box_sum(q, TARGET, TARGET), _box_sum(x, TARGET, TARGET)

    k_ms, p_ms, kr, pr = time_in_turns(
        kernel, lambda: window_sums_torch(x, TARGET, TARGET, sq=True, sums=True), 100, 20)
    lib_ms = ms_per_call(gemms, 20)
    ho, wo = TRACK_H - TARGET + 1, TRACK_W - TARGET + 1
    # x read once, Σ_c x² and the three per-channel sums written once; the
    # adds of the separable direct sums (a th-tap column sum for every
    # output row and input column, a tw-tap row sum for every output, of x
    # and x² in each channel) and the squares.
    moved = (x.numel() + 4 * ho * wo) * 4
    adds = 3 * 2 * (ho * TRACK_W * (TARGET - 1) + ho * wo * (TARGET - 1)) + x.numel()
    by_bytes, by_ops = moved / HBM_TBPS / 1e9, adds / FP32_TFLOPS / 1e9
    dev_k = device_us(kernel, "window_sum_kernel")
    dev_g = device_us(gemms)
    log(f"[time] window sums must move {moved / 1e6:.1f} MB ({by_bytes * 1e3:.2f} us) and do "
        f"{adds / 1e9:.3f} G f32 ops ({by_ops * 1e3:.2f} us); profiler device time per call: "
        f"kernel {fmt_us(dev_k)}, the ones-band GEMMs {fmt_us(dev_g)}; GEMMs {lib_ms:.4f} ms/call "
        f"[{card}]")
    report(f"window sums (3, {TRACK_H}, {TRACK_W}) HWC, {TARGET}x{TARGET}", k_ms, p_ms, kr, pr,
           moved, (1, "frames"), card)
    # The data behind launch_plan's strip height: the profiler's device
    # time at each height, HWC and planar, both sums.
    plan = launch_plan(3, TRACK_H, TRACK_W, TARGET, TARGET, sq=True, sums=True,
                       sms=torch.cuda.get_device_properties(0).multi_processor_count)
    planar = x.contiguous()
    for rows in (16, 32, 48, 56, 64, 88, 136, 232):
        us = [device_us(lambda: _launch(v, TARGET, TARGET, True, True, rows),
                        "window_sum_kernel") for v in (x, planar)]
        log(f"[time] window sums rows={rows}{' (the plan)' if rows == plan.rows else ''}: "
            f"HWC {fmt_us(us[0])}, planar {fmt_us(us[1])} [{card}]")
    return timing(k_ms, p_ms, max(by_bytes, by_ops),
                  "bytes" if by_bytes >= by_ops else "operations", lib_ms)


def time_planar(card: str) -> dict:
    """The fused kernel on config 5's warped planes (2 x 3 x 684 x 1216 u8
    → 224, linear, self statistics: the config-5 tail) against its plain
    version and its bound; its queued device time at 2 frames and at 1
    (beside config 4's one frame)."""
    from vacv_tpu_torch.ops.cuda.preprocess import (
        _resize_weights, preprocess_fused_planes, preprocess_fused_planes_torch,
    )

    planes = config5_planes(BATCH5, 74)
    out = (OUT, OUT)
    k_ms, p_ms, kr, pr = time_in_turns(lambda: preprocess_fused_planes(planes, out),
                                       lambda: preprocess_fused_planes_torch(planes, out), 100, 10)
    h, w = planes.shape[-2:]
    rows = int(np.count_nonzero(_resize_weights(h, OUT, "linear").any(axis=0)))
    src = BATCH5 * 3 * rows * w
    moved = src + BATCH5 * 3 * OUT * OUT * 4
    queued = {n: queued_us(lambda n=n: preprocess_fused_planes(planes[:n], out)) for n in (1, 2)}
    static = queued_us(lambda: preprocess_fused_planes(planes, out, **STATIC))
    log(f"[time] planar tail: taps touch {rows}/{h} rows; the kernel must move "
        f"{moved / 1e6:.2f} MB (source {src / 1e6:.2f} MB + out "
        f"{BATCH5 * 3 * OUT * OUT * 4 / 1e6:.2f} MB); queued device time self stats "
        f"{queued[1]:.2f} us at 1 frame, {queued[2]:.2f} us at {BATCH5}; static {static:.2f} us "
        f"at {BATCH5} [{card}]")
    report(f"planar tail {BATCH5}x3x{h}x{w} -> {OUT}", k_ms, p_ms, kr, pr, moved,
           (BATCH5, "frames"), card)
    return timing(k_ms, p_ms, moved / HBM_TBPS / 1e9, "bytes")


def time_fused_warp(card: str) -> dict:
    """The fused warp against the two-launch chain at config 5, device top,
    2 and 16 frames: queued device time (``queued_us``) and the profiler's
    device time by kernel, in turns (chain, fused, fused, chain); its bound
    (``portbench/work.py``'s bytes of the chain at 3.35 TB/s); the plain
    chain (``warp_planes_batch_torch``, then ``preprocess_fused_planes_torch``)
    at 2 frames for the kernels line."""
    from portbench import work

    cfg = json.loads(Path("portbench/configs/cfg5_warp_1440p.json").read_text())
    top = torch.tensor(RECT5[1], dtype=torch.int32, device="cuda")
    result = None
    for n in (BATCH5, BATCH5_HOST):
        batch = make_batch(n, H5, W5, seed=180 + n)
        fused, chain, plain, _ = fused_warp_pair(batch, "linear", top)
        queued = [queued_us(f) for f in (chain, fused, fused, chain)]
        prof = [device_profile(f, 20) for f in (chain, fused)]
        bound = work.chain_bytes(cfg, n) / HBM_TBPS / 1e6  # us
        log(f"[time] fused warp config 5, {n} frames, device top: queued device "
            f"{queued[1]:.2f}, {queued[2]:.2f} us against the two-launch chain's "
            f"{queued[0]:.2f}, {queued[3]:.2f} us; profiler {prof[1][0]:.2f} us against "
            f"{prof[0][0]:.2f} us; the chain's bytes at {HBM_TBPS} TB/s {bound:.2f} us = "
            f"{100 * bound / min(queued[1:3]):.1f}% of the fused form's queued time [{card}]")
        for label, (_, kernels) in zip(("chain", "fused"), prof):
            for k, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
                log(f"[time]   {label}: {t:9.2f} us/batch  {c:g} launches/batch  {k[:110]}")
        if n == BATCH5:
            k_ms, p_ms, kr, pr = time_in_turns(fused, plain, 100, 5)
            report(f"fused warp config 5 {n} frames", k_ms, p_ms, kr, pr,
                   work.chain_bytes(cfg, n), (n, "frames"), card)
            result = timing(k_ms, p_ms, bound / 1e3, "bytes")
    return result


def sass_functions(lib: Path) -> dict:
    """{demangled kernel name: [its SASS bodies]} of a kernel library, by
    ``cuobjdump -sass`` and ``cu++filt``; a kernel compiled in two sources
    has two bodies."""
    cuda = Path("/usr/local/cuda/bin")
    text = subprocess.run([str(cuda / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    bodies, name, lines = {}, None, []
    for line in text.splitlines() + ["Function : <end>"]:
        if "Function : " in line:
            if name is not None:
                bodies.setdefault(name, []).append("\n".join(lines))
            name, lines = line.split("Function : ", 1)[1].strip(), []
        elif name is not None and line.strip().startswith("/*"):
            lines.append(line.strip())
    names = list(bodies)
    import shutil

    filt = next(f for f in (str(cuda / "cu++filt"), shutil.which("c++filt")) if f and Path(f).exists())
    demangled = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                               check=True).stdout.splitlines()
    out = {}
    for m, d in zip(names, demangled):  # "<unnamed>" and "(int)2" as the profiler spells them
        d = d.replace("<unnamed>", "(anonymous namespace)").replace("(int)", "")
        out.setdefault(d, []).extend(bodies[m])
    return out


def compare_sass(parent: Path) -> None:
    """Each kernel of the parent's library against this tree's, SASS for
    SASS: the parent's library built in a fresh process in ``parent``,
    both dumped by ``sass_functions``.  Config 4's
    ``moments_resize_kernel<BgrSource, 2, 2>``, ``scale_u8_kernel`` and the
    tracking frame's ``nv_one_pass_kernel`` must be unchanged."""
    from vacv_tpu_torch.ops.cuda import build

    proc = subprocess.run([sys.executable, "-c", "from vacv_tpu_torch.ops.cuda import build; "
                           "print(build.library().path)"], cwd=parent, capture_output=True,
                          text=True, timeout=900)
    require(proc.returncode == 0, f"the parent's library did not build: {proc.stderr[-2000:]}")
    old = sass_functions(Path(proc.stdout.strip().splitlines()[-1]))
    new = sass_functions(build.library().path)
    same = [k for k in old if k in new and all(b in new[k] for b in old[k])]
    changed = [k for k in old if k in new and k not in same]
    added = [k for k in new if k not in old]
    log(f"[sass] {len(same)} kernels of the parent unchanged, {len(changed)} changed, "
        f"{len(added)} new, {len([k for k in old if k not in new])} gone")
    for k in changed:
        log(f"[sass]   changed: {k[:160]}")
    for k in added:
        log(f"[sass]   new: {k[:160]} ({len(new[k][0].splitlines()) // 2} instructions)")
    for want in ("moments_resize_kernel<(anonymous namespace)::BgrSource, 2, 2>",
                 "scale_u8_kernel", "nv_one_pass_kernel"):
        keys = [k for k in old if want in k]
        require(keys and all(k in same for k in keys), f"{want}: SASS not the parent's")
        log(f"[sass] {want}: unchanged ({len(keys)} instantiation(s), "
            f"{', '.join(str(len(old[k][0].splitlines()) // 2) for k in keys)} instructions)")


# Kernel-name parts of the tracking frame's named shares.
TRACKING_SHARES = {
    "fused NV kernel": ("nv_one_pass", "NvSource", "normalize_kernel"),
    "yuv2bgr": ("yuv2bgr",),
    "stack to HWC after the decode": ("CatArrayBatchedCopy",),
    "correlation": ("corr_kernel", "split_sum"),
    "window sums": ("window_sum_kernel",),
}


def tracking_breakdown(run, card: str, n: int = 10) -> None:
    """One tracking frame's device time by kernel (the profiler over ``n``
    frames): the fused NV kernel's, yuv2bgr's, the stack copy's, the
    correlation's and the window sums' shares, then the largest kernels;
    no GEMM may run (the window sums left the ones-band products)."""
    from vacv_tpu_torch.utils.perf import profiler_trace

    run()
    torch.cuda.synchronize()
    with profiler_trace("build/tracking_trace") as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    kernels = [(getattr(e, "device_time_total", 0) or 0, e.count, e.key)
               for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(t for t, _, _ in kernels) / n
    log(f"[time] tracking frame profiler device time {total:.2f} us/frame [{card}]")
    for name, keys in TRACKING_SHARES.items():
        t = sum(t for t, _, k in kernels if any(s in k for s in keys)) / n
        log(f"[time]   {name}: {t:.2f} us/frame {100 * t / total:5.1f}%")
    for t, count, key in sorted(kernels, reverse=True)[:8]:
        log(f"[time]   {t / n:9.2f} us/frame {100 * t / n / total:5.1f}%  {count // n} "
            f"launches/frame  {key[:90]}")
    gemms = [k for _, _, k in kernels if "gemm" in k.lower()]
    require(not gemms, f"the tracking frame ran GEMMs: {gemms}")
    log(f"[time]   no GEMM in the tracking frame ({len(kernels)} kernels)")


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
    from vacv_tpu_torch.ops.cuda.probe import probe_dot, probe_dot_torch, split_plan

    shapes = [(96, 128, 2048, 64, dt) for dt in (torch.bfloat16, torch.int8)]
    shapes += [(96, k, 1024, 64, torch.int8) for k in (32, 64, 96, 128)]
    shapes += [(1024, 1024, 1024, 32, dt) for dt in (torch.bfloat16, torch.int8)]
    shapes += [(37, 64, 75, 5, dt) for dt in (torch.bfloat16, torch.int8)]
    shapes += [(17, 96, 9, 1, dt) for dt in (torch.bfloat16, torch.int8)]
    # The split-reps path (reps not a multiple of the split; one tile over
    # sixteen blocks) and ragged tile edges in M, N and K.
    shapes += [(96, 128, 1024, 67, dt) for dt in (torch.bfloat16, torch.int8)]
    shapes += [(1, 32, 8, 64, dt) for dt in (torch.bfloat16, torch.int8)]
    shapes += [(130, 160, 200, 7, torch.bfloat16), (130, 192, 200, 7, torch.int8)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (m, k, n, reps, dt) in enumerate(shapes):
        a, b = probe_operands(m, k, n, reps, dt, seed=80 + i)
        label = f"probe {m}x{k}x{n} reps={reps} {dt} splits={split_plan(m, n, reps, sms)}"
        got = probe_dot(a, b, reps)
        check(label, got, probe_dot_torch(a, b, reps), "exact")
        require(torch.equal(probe_dot(a, b, reps), got), f"{label}: differs between runs")
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
    the profiler's device time per call of the kernels and of the library
    call, and the plain version at the 1024³ bf16 shape, which the kernels
    line reports."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.ops.cuda.probe import probe_dot, probe_dot_torch
    from vacv_tpu_torch.profile import probe_i8

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
    # The kernels alone: the profiler's device time per call (the probe
    # kernel and, for a split tile, the launch that adds the splits),
    # against the event slope (which includes the host's launch cost where
    # that is longer than the kernel), and the same for the library call on
    # the windows laid side by side.
    for m, k, n, reps, dt in ((96, 128, 2048, 64, torch.bfloat16),
                              (96, 128, 2048, 64, torch.int8),
                              (1024, 1024, 1024, 32, torch.bfloat16),
                              (1024, 1024, 1024, 32, torch.int8)):
        a, b = probe_operands(m, k, n, reps, dt, seed=95)
        flops = 2 * m * k * n * reps
        kernel = device_us(lambda: probe_dot(a, b, reps), "probe_kernel")
        call = device_us(lambda: probe_dot(a, b, reps))
        wide, tall = probe_i8.library_operands(a, b, reps)
        lib = device_us(lambda: probe_i8.library_call(wide, tall))
        rate = "" if call is None else f" = {flops / call * 1e-6:.2f} T/s"
        log(f"[time] probe {m}x{k}x{n} reps={reps} {dt}: profiler device time per call "
            f"{fmt_us(call)}{rate} (probe_kernel {fmt_us(kernel)}); library "
            f"{'torch._int_mm' if dt == torch.int8 else 'torch.matmul'} {fmt_us(lib)} [{card}]")
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
    the 1e-4 bar, and the kernels of configs 2, 4 and 5 (the fused warp)
    must have run."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.profile import CvProfile

    config.reset_kernel_counts()
    prof = CvProfile(k_test_times=2, k_log_batch_size=2)
    prof.profile(harness_tests(), verbose=True)
    torch.cuda.synchronize()
    names = ("yuv2bgr", "preprocess_fused", "preprocess_fused_warp")
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


def config4_preprocessor():
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor

    return Preprocessor(PreprocessConfig(crop_rect=VRect(LEFT, TOP, LEFT + CW, TOP + CH),
                                         out_size=(OUT, OUT)), device="cuda")


SERVE_FRAMES = 16


def phase_serve(card: str) -> int:
    """The serving layer: 16 numpy 1080p frames through
    ``stream_map(pre, frames, depth=4)`` (the tap tables' cache emptied
    first) and ``StreamExecutor(pre, depth=2)`` with the config-4
    Preprocessor; every output bit for bit against ``pre(frame)`` run one
    at a time afterwards, in order, one launch a frame; then frames/s at
    depth 1 and 4 (the frames served four times a run, in turns 1, 4, 4,
    1), copies to the card included, in CUDA-event time.  Returns the
    launches counted."""
    import time

    from vacv_tpu_torch import config
    from vacv_tpu_torch.models import StreamExecutor, stream_map

    from vacv_tpu_torch.ops.cuda.preprocess import _device_taps

    pre = config4_preprocessor()
    frames = list(np.random.default_rng(70).integers(0, 256, (SERVE_FRAMES, H, W, 3),
                                                     dtype=np.uint8))
    _device_taps.cache_clear()  # the first frame fills the tap tables on a side stream
    config.reset_kernel_counts()
    mapped = list(stream_map(pre, frames, depth=4))
    torch.cuda.synchronize()
    n_map = config.kernel_count("preprocess_fused")
    config.reset_kernel_counts()
    ex = StreamExecutor(pre, depth=2)
    handed = [ex.submit(f) for f in frames]
    drained = list(ex.drain())
    torch.cuda.synchronize()
    n_ex = config.kernel_count("preprocess_fused")
    plain = config.kernel_count("preprocess_fused_torch")
    refs = [pre(f) for f in frames]
    log(f"[serve] preprocess_fused launches: stream_map {n_map}, StreamExecutor {n_ex} "
        f"for {SERVE_FRAMES} frames each")
    require(n_map == n_ex == SERVE_FRAMES and plain == 0, f"serve launches {n_map}, {n_ex}")
    require(handed[0] is None and all(h is not None for h in handed[1:]) and len(drained) == 1,
            "StreamExecutor(depth=2) did not hand back the oldest result from the second submit")
    for label, outs in (("stream_map depth 4", mapped),
                        ("StreamExecutor depth 2", handed[1:] + drained)):
        require(len(outs) == SERVE_FRAMES, f"{label}: {len(outs)} results")
        same = [torch.equal(o, r) for o, r in zip(outs, refs)]
        log(f"[serve] {label}: in order and bit-exact against pre(frame) one at a time: "
            f"{sum(same)}/{SERVE_FRAMES}")
        require(all(same), f"{label}: an output differs from pre(frame)")

    def frames_per_s(depth, cycles=4):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        n = sum(1 for _ in stream_map(pre, frames * cycles, depth=depth))
        end.record()
        end.synchronize()
        return n / start.elapsed_time(end) * 1e3, n / (time.perf_counter() - t0)

    check_tables_across_streams()
    runs = {1: [], 4: []}
    for depth in (1, 4, 4, 1):
        runs[depth].append(frames_per_s(depth))
    for depth, r in runs.items():
        log(f"[time] serve stream_map depth {depth}: {r[0][0]:.1f}, {r[1][0]:.1f} frames/s "
            f"(CUDA events), {r[0][1]:.1f}, {r[1][1]:.1f} frames/s (host clock); "
            f"{SERVE_FRAMES} numpy 1080p frames served 4 times a run, copies to the card "
            f"included [{card}]")
    return n_map + n_ex


def check_tables_across_streams(frames=96) -> None:
    """The cached tap tables under serving: ``stream_map(depth=4)`` over 96
    frames, each with its own crop and output size (192 tap tables, three
    times what the cache holds, so tables are dropped while other lanes
    still run), bit for bit against the same calls made one at a time on
    the default stream afterwards; the cache emptied first."""
    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.models import stream_map
    from vacv_tpu_torch.ops.cuda.preprocess import _device_taps, preprocess_fused_batch

    batch = make_batch(frames, 360, 640, seed=77)
    shapes = [(VRect(k % 37, k % 23, k % 37 + 400 + k, k % 23 + 200 + k), (96 + k, 64 + k))
              for k in range(frames)]
    order = iter(range(frames))

    def fn(frame):
        rect, out = shapes[next(order)]
        return preprocess_fused_batch(frame[None], rect, out)

    _device_taps.cache_clear()
    mapped = list(stream_map(fn, list(batch), depth=4))
    torch.cuda.synchronize()
    info = _device_taps.cache_info()
    refs = [preprocess_fused_batch(f[None], *shapes[k]) for k, f in enumerate(batch)]
    same = sum(torch.equal(m, r) for m, r in zip(mapped, refs))
    log(f"[serve] stream_map depth 4 over {frames} crop/output shapes ({info.misses} tap-table "
        f"misses, cache of {info.maxsize}): {same}/{frames} bit-exact against one stream")
    require(info.misses > info.maxsize and same == frames,
            "tap tables across streams: an output differs")


def phase_mesh(card: str) -> dict:
    """The scale-out layer on one card: ``make_mesh()`` (a world of one
    over NCCL); ``pre.batched(mesh)`` over the config-4 batch equal to
    ``pre.batch`` bit for bit in one launch; ``shard_batched_with_stats``
    over ``pre.fn`` equal to the stacked ``pre.fn`` outputs, its
    all-reduced mean of the frames' channel means within rtol 1e-5;
    ``entry()`` on cuda:0 in one launch; ``dryrun_multichip(1)``; the
    host µs a call of ``batched`` against ``batch``.  Returns the
    launches counted."""
    import torch.distributed as dist

    from vacv_tpu_torch import config
    from vacv_tpu_torch.entry import dryrun_multichip, entry
    from vacv_tpu_torch.parallel import make_mesh, put_sharded, shard_batched_with_stats

    mesh = make_mesh()
    log(f"[mesh] {mesh}: backend {dist.get_backend()}, world {dist.get_world_size()}")
    require(mesh.size() == 1 and mesh.device_type == "cuda" and dist.get_backend() == "nccl",
            "make_mesh() on one card is not an NCCL world of one")
    pre = config4_preprocessor()
    batch = make_batch(BATCH, H, W, seed=80)
    config.reset_kernel_counts()
    sharded = pre.batched(mesh)(put_sharded(batch, mesh))
    torch.cuda.synchronize()
    launches = {"preprocess_fused": config.kernel_count("preprocess_fused")}
    require(launches["preprocess_fused"] == 1 and config.kernel_count("preprocess_fused_torch") == 0,
            f"batched launched the fused kernel {launches['preprocess_fused']} times, expected 1")
    local = sharded.to_local()
    require(local.device == torch.device("cuda", 0) and torch.equal(local, pre.batch(batch)),
            "batched(mesh) differs from batch")
    log(f"[mesh] batched over {BATCH}x{H}x{W}: bit-exact against batch, one launch")

    def per_image(x):
        return pre.fn(x), x.float().mean(dim=(0, 1))

    config.reset_kernel_counts()
    outs, stat = shard_batched_with_stats(per_image, mesh)(put_sharded(batch, mesh))
    torch.cuda.synchronize()
    launches["normalize_fused"] = config.kernel_count("normalize_fused")
    require(launches["normalize_fused"] == BATCH, f"pre.fn launched normalize "
            f"{launches['normalize_fused']} times for {BATCH} frames")
    want = torch.stack([pre.fn(f) for f in batch])
    want_mean = batch.double().mean(dim=(1, 2)).mean(dim=0)
    got_mean = stat.to_local().double()
    rel = ((got_mean - want_mean).abs() / want_mean.abs()).max().item()
    log(f"[mesh] shard_batched_with_stats: outputs bit-exact {torch.equal(outs.to_local(), want)}, "
        f"channel means {got_mean.tolist()} against {want_mean.tolist()} (max rel {rel})")
    require(torch.equal(outs.to_local(), want), "shard_batched_with_stats outputs differ")
    require(rel <= 1e-5, "the all-reduced mean is off")

    fn, args = entry()
    config.reset_kernel_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    n = config.kernel_count("preprocess_fused")
    require(out.device == torch.device("cuda", 0) and tuple(out.shape) == (8, 3, OUT, OUT)
            and bool(torch.isfinite(out).all()) and n == 1, f"entry(): {out.device}, {n} launches")
    launches["preprocess_fused"] += n
    log(f"[mesh] entry(): {tuple(out.shape)} on {out.device}, one launch")
    log(f"[mesh] dryrun_multichip(1): batch-mean {dryrun_multichip(1)}")

    dt = put_sharded(batch, mesh)
    run = pre.batched(mesh)

    us = [host_us(lambda: pre.batch(batch)), host_us(lambda: run(dt)),
          host_us(lambda: run(dt)), host_us(lambda: pre.batch(batch))]
    log(f"[time] host us a call, {BATCH}x{H}x{W}: batched(mesh) {us[1]:.1f}, {us[2]:.1f}; "
        f"batch {us[0]:.1f}, {us[3]:.1f} [{card}]")
    return launches


def phase_examples(card: str) -> dict:
    """Both examples' ``main()`` on the card: the tracker within 2 px on
    every frame (it raises otherwise), its first frame run eagerly and then
    captured ``Tracker.SLOTS`` times (each of its kernels counted once in
    each), every later frame one graph replay; the SLAM front end's sharded
    output equal to ``pre.batch`` bit for bit.  Returns the launches
    counted."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.examples import camera_tracking, slam_frontend
    from vacv_tpu_torch.models.tracking import Tracker
    from vacv_tpu_torch.utils import trace

    config.reset_kernel_counts()
    replays = trace.counter("track.graph_replays")
    results = camera_tracking.main([])
    torch.cuda.synchronize()
    replays = trace.counter("track.graph_replays") - replays
    names = ("yuv2bgr", "match_corr", "window_sum", "preprocess_fused_nv")
    launches = {k: config.kernel_count(k) for k in names}
    log(f"[examples] camera_tracking launches={launches}, graph replays {replays}, for "
        f"{len(results)} frames")
    require(launches == dict.fromkeys(names, 1 + Tracker.SLOTS) and len(results) == 6
            and replays == len(results) - 1, f"camera_tracking launches {launches}, replays "
            f"{replays}")
    require(all(abs(r["found"][0] - r["truth"][0]) <= 2 and abs(r["found"][1] - r["truth"][1]) <= 2
                for r in results), "camera_tracking lost the target")
    require(all(r["net_in"].device.type == "cuda" for r in results), "camera_tracking off the card")
    config.reset_kernel_counts()
    pre, nv_batch, out = slam_frontend.main([])
    torch.cuda.synchronize()
    n = config.kernel_count("preprocess_fused_nv")
    require(all(config.kernel_count(f"{k}_torch") == 0 for k in names),
            "an example fell back to a plain version")
    launches["preprocess_fused_nv"] += n
    local = out.to_local()
    log(f"[examples] slam_frontend: {tuple(local.shape)} on {local.device}, "
        f"{n} preprocess_fused_nv launches (one frame, 2 warm-up and 5 timed batches)")
    require(n == 8, f"slam_frontend launched the NV kernel {n} times, expected 8")
    require(local.device == torch.device("cuda", 0) and torch.equal(local, pre.batch(nv_batch)),
            "slam_frontend's sharded output differs from pre.batch")
    return launches


def tree_kernel_times(tree: Path, tag: str) -> dict:
    """``--kernel-times`` of this script run in a fresh process in ``tree``
    (this checkout, or one of an earlier commit with this script copied
    in): {label: [µs, launches]}."""
    import shutil

    script = Path(__file__).resolve()
    if script.parent != tree.resolve():
        shutil.copy(script, tree / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--kernel-times"], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and lines and lines[-1].startswith('{"kernel_times"'),
            f"the {tag}'s kernel times failed ({proc.returncode}): {proc.stderr[-2000:]}")
    for line in lines:
        if line.startswith("[time]"):
            log(f"[{tag}] {line}")
    return json.loads(lines[-1])["kernel_times"]


def side_by_side(runs, card: str) -> None:
    """Each kernel-times label: parent, change, change, parent."""
    log(f"[time] parent / change / change / parent, us a call, each a fresh process (config 4: "
        f"queued device time; the rest: the profiler's) [{card}]")
    for label in runs[1]:
        values = [r.get(label, [None])[0] for r in runs]
        log(f"[time]   {label}: " + " / ".join("-" if v is None else f"{v:.2f}" for v in values))


def main() -> int:
    card = phase_device()
    import vacv_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_build()
    if sys.argv[1:] == ["--kernel-times"]:
        print(json.dumps({"kernel_times": kernel_times(card, CONFIG4_BATCHES)}), flush=True)
        return 0
    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    if "--align" in sys.argv:
        phase_compare_align()
        phase_main_align()
        time_align(card)
        if parent:
            compare_sass(Path(parent))
        print(json.dumps({"ok": True, "align": True}), flush=True)
        return 0
    if "--fused-warp" in sys.argv:
        phase_compare_fused_warp()
        time_fused_warp(card)
        if parent:
            compare_sass(Path(parent))
        print(json.dumps({"ok": True, "fused_warp": True}), flush=True)
        return 0
    errs = {
        "preprocess_fused": phase_compare(),
        "preprocess_fused_nv": phase_compare_nv(),
        "yuv2bgr": phase_compare_yuv2bgr(),
        "normalize_fused": phase_compare_normalize(),
        "warp_affine": max(phase_compare_warp(), phase_compare_warp_top()),
        "match_corr": phase_compare_corr(),
        "probe_dot": phase_compare_probe(),
        "preprocess_fused_planar": phase_compare_planar(),
        "window_sum": phase_compare_window_sum(),
        "preprocess_fused_warp": phase_compare_fused_warp(),
        "align_faces": phase_compare_align(),
    }
    # Each main path is driven with the counts set to 0 just before it
    # and read just after (inside each phase).
    launches = {"preprocess_fused": phase_main_path(), "preprocess_fused_nv": phase_main_nv()}
    chain = phase_main_nv_chain()
    launches["yuv2bgr"] = chain["yuv2bgr"] + phase_main_config2()
    launches["normalize_fused"] = chain["normalize_fused"]
    config5 = phase_main_config5()
    for k in ("warp_affine", "preprocess_fused_planar", "preprocess_fused_warp"):
        launches[k] = config5[k]
    tracking = phase_main_tracking()
    launches["match_corr"] = tracking["match_corr"]
    launches["window_sum"] = tracking["window_sum"]
    launches["yuv2bgr"] += tracking["yuv2bgr"]
    launches["preprocess_fused_nv"] += tracking["preprocess_fused_nv"]
    launches["probe_dot"], probe_times = phase_main_probe(card)
    launches["align_faces"] = phase_main_align()
    harness = phase_harness(card)
    for k in ("yuv2bgr", "preprocess_fused", "preprocess_fused_warp"):
        launches[k] += harness[k]
    frontend = phase_frontend(card)
    launches["preprocess_fused"] += frontend["preprocess_fused"]
    launches["preprocess_fused_nv"] += frontend["preprocess_fused_nv"]
    launches["preprocess_fused"] += phase_serve(card)
    for phase in (phase_mesh, phase_examples):
        for k, n in phase(card).items():
            launches[k] += n
    import torch.distributed as dist

    dist.destroy_process_group()  # the NCCL world of one from make_mesh()
    times = {"preprocess_fused": phase_time(card), **phase_time_nv(card),
             **phase_time_warp_corr(card), "probe_dot": probe_times,
             "preprocess_fused_warp": time_fused_warp(card), "align_faces": time_align(card)}
    per_call = kernel_times(card)
    for label, (_, n_launches) in per_call.items():
        if label.startswith(("normalize", "warp", "yuv2bgr", "NV21")):
            require(n_launches == 1, f"{label}: {n_launches} kernel launches per call, expected 1")
    log("[time] normalize, warp, yuv2bgr and the fused NV kernel (self and static statistics): "
        "one kernel launch per call at every timed shape")
    check_written_once(card)
    if parent:  # each tree's times in fresh processes, in turns
        compare_sass(Path(parent))
        here = Path(__file__).resolve().parent
        runs = [tree_kernel_times(Path(parent), "parent"), tree_kernel_times(here, "change"),
                tree_kernel_times(here, "change"), tree_kernel_times(Path(parent), "parent")]
        side_by_side(runs, card)
    time_table_lookup(card)
    time_forms_and_paths(card)
    time_yuv2bgr_widths(card)
    time_nv_one_pass_sweep(card)
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
