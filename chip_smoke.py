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
   u8, (3, 224, 224));
4. main paths, each with the launch counters reset just before and read
   just after: config 4 (``Preprocessor.batch`` on three batches with a
   moving crop top held on the device), the fused NV camera path (the
   same, on NV21 buffers), the NV chain (a cubic NV config: yuv2bgr and
   normalize once per frame) and config 2 (``cvt_color`` → CHW → f32);
   each result is held against the plain PyTorch chain;
5. time: each kernel against its plain version with CUDA events, in
   turns, and the main paths.

The last three lines are the kernels' JSON record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import subprocess
import sys

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
}


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


def time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_time(card: str) -> tuple[float, float]:
    import numpy as np

    from vacv_tpu_torch.core.types import VRect
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
    from vacv_tpu_torch.ops.cuda.preprocess import (
        _resize_weights, preprocess_fused_batch, preprocess_fused_batch_torch,
    )

    rect = VRect(LEFT, TOP, LEFT + CW, TOP + CH)
    batch = make_batch(BATCH, H, W, seed=0)
    kern = lambda: preprocess_fused_batch(batch, rect, (OUT, OUT))  # noqa: E731
    plain = lambda: preprocess_fused_batch_torch(batch, rect, (OUT, OUT))  # noqa: E731
    for _ in range(3):
        kern()
        plain()
    torch.cuda.synchronize()
    # In turns: plain, kernel, kernel, plain.
    p1, k1, k2, p2 = (time_ms(plain, 10), time_ms(kern, 50),
                      time_ms(kern, 50), time_ms(plain, 10))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
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
    for name, runs, ms in (("kernel", (k1, k2), k_ms),
                           ("plain", (p1, p2), p_ms)):
        log(f"[time] {name}: {ms:.4f} ms/batch of {BATCH} "
            f"(runs {runs[0]:.4f}, {runs[1]:.4f}), "
            f"{BATCH / ms * 1e3:.1f} frames/s, "
            f"{moved / ms / 1e6:.1f} GB/s = "
            f"{100 * moved / ms / 1e9 / HBM_TBPS:.2f}% of {HBM_TBPS} TB/s "
            f"[{card}]")
    # The main path as a user calls it, crop top on the device.
    pre = Preprocessor(PreprocessConfig(crop_rect=rect, out_size=(OUT, OUT)),
                       device="cuda")
    top = torch.tensor(TOP, dtype=torch.int32, device="cuda")
    main_ms = time_ms(lambda: pre.batch(batch, top=top), 50)
    log(f"[time] main path Preprocessor.batch: {main_ms:.4f} ms/batch of "
        f"{BATCH}, {BATCH / main_ms * 1e3:.1f} frames/s [{card}]")
    return k_ms, p_ms


def time_in_turns(kern, plain, k_iters, p_iters):
    """(kernel ms, plain ms, kernel runs, plain runs) per call, CUDA
    events after warm-up, in turns: plain, kernel, kernel, plain."""
    for _ in range(3):
        kern()
        plain()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (time_ms(plain, p_iters), time_ms(kern, k_iters),
                      time_ms(kern, k_iters), time_ms(plain, p_iters))
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
    fused NV main path.  Returns {name: (kernel ms, plain ms)}."""
    import numpy as np

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
    times["preprocess_fused_nv"] = (k_ms, p_ms)

    buf = nv[0]
    y, vu = buf[:H], buf[H:]
    k_ms, p_ms, kr, pr = time_in_turns(lambda: nv_to_bgr(y, vu, is_nv12=False),
                                       lambda: nv_to_bgr_planes_torch(y, vu, is_nv12=False),
                                       200, 20)
    moved = H * W * 3 // 2 + 3 * H * W
    log(f"[time] yuv2bgr must move {moved / 1e6:.2f} MB (1.5 B/px in, 3 B/px out)")
    report(f"yuv2bgr {H}x{W}", k_ms, p_ms, kr, pr, moved, (1, "frames"), card)
    times["yuv2bgr"] = (k_ms, p_ms)

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    x = torch.randint(0, 256, (3, H, W), generator=g, device="cuda").to(torch.float32)
    k_ms, p_ms, kr, pr = time_in_turns(
        lambda: normalize_fused(x), lambda: normalize_torch(Image(x, Layout.CHW)), 100, 20)
    moved = 3 * x.numel() * 4
    log(f"[time] normalize must move {moved / 1e6:.1f} MB (2 f32 reads + 1 f32 write)")
    report(f"normalize f32 (3, {H}, {W})", k_ms, p_ms, kr, pr, moved, (1, "images"), card)
    times["normalize_fused"] = (k_ms, p_ms)

    pre = Preprocessor(PreprocessConfig(color_code=ColorCode.COLOR_YUV2BGR_NV21,
                                        crop_rect=rect, out_size=(OUT, OUT)), device="cuda")
    top = torch.tensor(TOP, dtype=torch.int32, device="cuda")
    main_ms = time_ms(lambda: pre.batch(nv, top=top), 50)
    log(f"[time] NV main path Preprocessor.batch: {main_ms:.4f} ms/batch of "
        f"{BATCH}, {BATCH / main_ms * 1e3:.1f} frames/s [{card}]")
    return times


def main() -> int:
    card = phase_device()
    import vacv_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_build()
    errs = {
        "preprocess_fused": phase_compare(),
        "preprocess_fused_nv": phase_compare_nv(),
        "yuv2bgr": phase_compare_yuv2bgr(),
        "normalize_fused": phase_compare_normalize(),
    }
    # Each main path is driven with the counts set to 0 just before it
    # and read just after (inside each phase).
    launches = {"preprocess_fused": phase_main_path(), "preprocess_fused_nv": phase_main_nv()}
    chain = phase_main_nv_chain()
    launches["yuv2bgr"] = chain["yuv2bgr"] + phase_main_config2()
    launches["normalize_fused"] = chain["normalize_fused"]
    times = {"preprocess_fused": phase_time(card), **phase_time_nv(card)}
    record = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": times[name][0],
        "plain_ms": times[name][1],
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
