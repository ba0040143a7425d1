"""End-to-end example: SLAM/vision front-end preprocessing on the card.

The counterpart of ``examples/slam_frontend.py``; the path a user takes:

1. load camera frames (JPEGs through the port's loader; synthetic 720p
   frames when no assets are given), brought to one even size with the
   port's own ``resize``,
2. synthesize NV21 (what a camera ISP hands over),
3. decode NV21 → crop the ROI → resize to the network input → CHW f32 →
   normalize in one fused launch,
4. run the same pipeline batch-sharded over the mesh
   (``Preprocessor.batched`` over ``make_mesh()``: every process of the
   group, one card each; a world of one on a single card).

Run: ``python -m vacv_tpu_torch.examples.slam_frontend [--assets DIR]``;
no cv2 is needed.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def load_frames(assets: str | None, n: int = 8) -> np.ndarray:
    """(n, H, W, 3) u8 BGR frames: the JPEGs under ``assets`` (repeated
    up to ``n``), or ``n`` synthetic 720p frames; all at the first
    frame's size, cut to even."""
    from ..ops.resize import resize
    from ..utils.loader import _decode

    paths = sorted(glob.glob(os.path.join(assets, "*.jp*g"))) if assets else []
    frames = []
    for p in paths:
        frames.append(_decode(p))
        print(f"loaded {os.path.basename(p)}: {frames[-1].shape}")
    if not frames:
        rng = np.random.default_rng(0)
        frames = [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(n)]
        print(f"no assets: using {n} synthetic 720p frames")
    h, w = frames[0].shape[0] // 2 * 2, frames[0].shape[1] // 2 * 2
    # on the host: a CPU tensor stays on the CPU
    frames = [f if f.shape[:2] == (h, w) else resize(torch.from_numpy(f), (w, h)).numpy()
              for f in frames]
    while len(frames) < n:
        frames.append(frames[len(frames) % len(paths)])
    return np.stack(frames[:n])


def main(argv=None):
    """The front end.  Returns (Preprocessor, the NV21 batch (numpy), the
    sharded output DTensor)."""
    ap = argparse.ArgumentParser(description="SLAM front-end preprocessing")
    ap.add_argument("--assets", default=None, help="a directory of JPEGs")
    args = ap.parse_args(argv)
    from .. import CHW, COLOR_YUV2BGR_NV21, VRect
    from ..models import PreprocessConfig, Preprocessor
    from ..parallel import make_mesh, put_sharded
    from ..utils.io import bgr2nv21
    from ..utils.perf import time_fn

    frames = load_frames(args.assets)
    n, h, w, _ = frames.shape
    print(f"batch: {frames.shape}")
    # 2. camera-format synthesis (host, native C++ when built)
    nv_batch = np.stack([bgr2nv21(f).reshape(h * 3 // 2, w) for f in frames])
    # 3. fused pipeline: NV21 -> BGR -> crop -> 224x224 -> CHW -> f32 -> normalize
    pre = Preprocessor(PreprocessConfig(
        color_code=COLOR_YUV2BGR_NV21,
        crop_rect=VRect(w // 8, h // 8, w - w // 8, h - h // 8),
        out_size=(224, 224),
        out_layout=CHW,
        normalize=True,
    ))
    one = pre(nv_batch[0])
    print(f"single-frame output: {tuple(one.shape)} {one.dtype} on {one.device} "
          f"mean={one.mean().item():.5f} std={one.std().item():.4f}")
    # 4. the batch sharded over the mesh
    mesh = make_mesh()
    batched = pre.batched(mesh)
    dev_batch = put_sharded(nv_batch, mesh)
    _, mean_ms, out = time_fn(batched, dev_batch, iters=5, warmup=2)
    print(f"sharded over {mesh.size()} {mesh.device_type} device(s): out {tuple(out.shape)}, "
          f"{mean_ms:.2f} ms/batch (host clock, launches included)")
    return pre, nv_batch, out


if __name__ == "__main__":
    main()
