#!/usr/bin/env python3
"""Smoke test of vacv_tpu_torch on one NVIDIA GPU: build, check, drive, time.

Run from the root of a checkout with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda),
and exits non-zero when either is missing or any phase fails.

Phases, each printed as it runs:

1. device: the card's name and power limit, TF32 off for the plain
   version's float32 matmuls;
2. build: the CUDA kernels from ``vacv_tpu_torch/csrc`` into
   ``build/vacv_tpu_torch/``, with nvcc's ``-Xptxas -v`` lines;
3. compare: every kernel of the main path against its plain PyTorch
   version on the card, at full width (32 frames of 1080x1920, the
   BASELINE config-4 crop, 224x224 out) and on odd frames;
4. main path: ``Preprocessor.batch`` on three batches with a moving crop
   top held on the device, with the launch counters reset just before;
   the result is held against the plain PyTorch chain;
5. time: kernel against plain version with CUDA events, in turns.

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
REPLACES = "vacv_tpu/ops/pallas/preprocess.py:328"
SOURCE = "vacv_tpu_torch/csrc/preprocess.cu"


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


def compare(label, batch, rect, out, kind, **kw) -> float:
    """Kernel vs plain version on the same CUDA inputs; returns max-abs."""
    from vacv_tpu_torch.ops.cuda.preprocess import (
        preprocess_fused_batch, preprocess_fused_batch_torch,
    )

    got = preprocess_fused_batch(batch, rect, out, **kw)
    torch.cuda.synchronize()
    want = preprocess_fused_batch_torch(batch, rect, out, **kw)
    torch.cuda.synchronize()
    require(got.shape == want.shape, f"{label}: shape {got.shape} vs {want.shape}")
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    d = (got - want).abs()
    max_abs = d.max().item()
    flips = (d > 0).double().mean().item()
    cos = cosine(got, want)
    log(f"[compare] {label}: max_abs={max_abs} flip_share={flips} "
        f"1-cos={1 - cos}")
    if kind == "lsb":   # truncated u8 planes: <= 1 LSB, rare flips
        require(max_abs <= 1.0 and flips < 1e-3, f"{label}: LSB bar")
    else:               # normalized output
        require(cos >= 1 - 1e-6 and max_abs < 0.05, f"{label}: cosine bar")
    return max_abs


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


def main() -> int:
    card = phase_device()
    import vacv_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_build()
    max_abs = phase_compare()
    launches = phase_main_path()
    k_ms, p_ms = phase_time(card)
    record = {"kernels": [{
        "name": "preprocess_fused",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}
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
