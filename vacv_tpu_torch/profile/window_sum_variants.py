"""Variant sweep of the window-sum kernel: the numbers behind the notes at
the head of ``csrc/window_sum.cu``.

Writes text-substituted copies of ``csrc/window_sum.cu`` into
``build/window_sum_variants/``, builds them side by side with ``nvcc`` (the
package's flags, each to a shared library of its own) and times each at the
tracking frame's shape, (3, 720, 1280) HWC planes of u8 values over 48 × 48
windows, both sums, at several strip heights: the stream is held busy while
the host enqueues 100 launches, then two CUDA events time them (device time
with launch gaps, no host; the median of three).  Variants that keep the
function are held to the plain version (within 1e-5 of the largest sum,
per-channel sums bit for bit); the diagnostic ones, which drop one part of
the kernel, are timed only.  Prints one line a variant and height, then the
card's name and power limit.

Run on the card:  python -m vacv_tpu_torch.profile.window_sum_variants
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from ..ops.cuda import build
from ..ops.cuda.window_sum import launch_plan, window_sums_torch

H, W, C, T = 720, 1280, 3, 48
ROWS = (48, 56, 64, 72)

LOAD = "__ldg(p + koff[k])"
ROW_PASS = "float sum = (e[0] + e[1]) + (e[2] + e[3]);"
UPDATE = "if (q < NQ) s[q] = __fsub_rn(__fadd_rn(s[q], u.v[q]), leave.v[q]);"
STORE = "*dst = first ? v : *dst + v;"


def variants() -> dict:
    """{name: (source text, threads a block, keeps the function)}."""
    src = (build.SRC_DIR / "window_sum.cu").read_text()
    for text in (LOAD, ROW_PASS, UPDATE, STORE, "constexpr int kSeg = 16;",
                 "constexpr int kTileX = 64;", "__syncthreads();"):
        if text not in src:
            raise RuntimeError(f"window_sum.cu no longer holds {text!r}")
    return {
        "as built": (src, 128, True),
        "32 outputs a row walk": (src.replace("kSeg = 16;", "kSeg = 32;"), 128, True),
        "8 outputs a row walk": (src.replace("kSeg = 16;", "kSeg = 8;"), 128, True),
        "128-column strips": (src.replace("kTileX = 64;", "kTileX = 128;"), 256, True),
        "no loads": (src.replace(LOAD, "static_cast<float>((r + k + b) & 7)"), 128, False),
        "no row pass": (src.replace(ROW_PASS, "float sum = row[0];").replace(
            "for (; i + 4 <= kc; i += 4) {", "for (; i + 4 <= 0; i += 4) {").replace(
            "for (; i < kc; ++i) e[0] += row[i * E];", ""), 128, False),
        "no column-sum updates": (src.replace(UPDATE, "if (q < NQ) s[q] = u.v[q];"), 128, False),
        "no barriers": (src.replace("__syncthreads();", ""), 128, False),
        "no stores": (src.replace(STORE, "if (v == 12345.f) *dst = v;").replace(
            "            *dst = v;", "            if (v == 12345.f) *dst = v;"), 128, False),
    }


def compile_all(out_dir: Path) -> dict:
    """{name: (ctypes function, threads, keeps the function)}; all built at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    jobs = {}
    for i, (name, (text, threads, keeps)) in enumerate(variants().items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        so = out_dir / f"v{i}.so"
        proc = subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, so, threads, keeps)
    built = {}
    for name, (proc, so, threads, keeps) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(so)).vacv_window_sum
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        fn.restype = i
        fn.argtypes = [i, p, p, i, i, i, ll, ll, ll, i, i, p, p, i, i, i, i]
        built[name] = (fn, threads, keeps)
    return built


def queued_us(run, reps: int = 100) -> float:
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * reps * 40e-6))
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps * 1e3)
    return sorted(times)[1]


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    built = compile_all(build.BUILD_DIR.parent / "window_sum_variants")
    g = torch.Generator(device="cuda")
    g.manual_seed(73)
    x = torch.randint(0, 256, (H, W, C), generator=g, device="cuda").float().permute(2, 0, 1)
    want_sq, want_sums = window_sums_torch(x, T, T, sq=True, sums=True)
    ho, wo = H - T + 1, W - T + 1
    sq = torch.empty((ho, wo), device="cuda")
    sums = torch.empty((C, ho, wo), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    plan = launch_plan(C, H, W, T, T, sq=True, sums=True)
    for name, (fn, threads, keeps) in built.items():
        for rows in ROWS:
            args = (0, stream, x.data_ptr(), C, H, W, *x.stride(), T, T, sq.data_ptr(),
                    sums.data_ptr(), rows, threads, plan.kr, plan.kc)

            def run():
                rc = fn(*args)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            us = queued_us(run)
            check = ""
            if keeps:
                run()
                torch.cuda.synchronize()
                ok = ((sq - want_sq).abs().max().item() <= 1e-5 * want_sq.abs().max().item()
                      and torch.equal(sums, want_sums))
                if not ok:
                    raise RuntimeError(f"{name} at {rows} rows differs from the plain version")
                check = ", held to the plain version"
            print(f"[window sums] {name}, {rows}-row strips: {us:.2f} us{check} [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
