"""End-to-end example: moving-ROI camera tracking on the card.

The counterpart of ``examples/camera_tracking.py``: a tracking camera
loop whose crop window FOLLOWS a target from frame to frame.

1. synthesize an NV21 camera stream with a drifting 48x48 target,
2. track it with ``models.Tracker``: find the target with
   ``match_template`` (TM_CCOEFF_NORMED, the correlation kernel) and
   ``min_max_loc`` on the decoded frame, then preprocess the frame's ROI
   through the fused NV kernel with the crop top held on the device: the
   window moves without a host round trip, and on the card every frame
   after the first is one CUDA graph replay.

Run: ``python -m vacv_tpu_torch.examples.camera_tracking [--frames N]
[--height H] [--width W]``; no cv2 is needed.
"""
from __future__ import annotations

import argparse

import numpy as np

TARGET = 48  # side of the square target, pixels


def make_stream(n_frames=6, h=720, w=1280, seed=3):
    """``n_frames`` stacked (h·3/2, w) NV21 frames (numpy) with a bright
    target drifting down and right, the target (BGR u8) and its true
    (x, y) in each frame.  At 720x1280 the target sits at (600 + 8 f,
    80 + 56 f) in frame f, as in the JAX example; other sizes scale it."""
    from ..utils.io import bgr2nv21_numpy

    y0, dy = 80 * h // 720, 56 * h // 720
    x0, dx = 600 * w // 1280, 8 * w // 1280
    if y0 + dy * (n_frames - 1) + TARGET > h or x0 + dx * (n_frames - 1) + TARGET > w:
        raise ValueError(f"{n_frames} frames of {h}x{w} leave the target no room")
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (h, w, 3), dtype=np.uint8)
    target = rng.integers(180, 256, (TARGET, TARGET, 3), dtype=np.uint8)
    frames, truth = [], []
    for f in range(n_frames):
        bgr = base.copy()
        ty, tx = y0 + dy * f, x0 + dx * f
        bgr[ty:ty + TARGET, tx:tx + TARGET] = target
        frames.append(bgr2nv21_numpy(bgr).reshape(h * 3 // 2, w))
        truth.append((tx, ty))
    return frames, target, truth


def track(n_frames=6, h=720, w=1280):
    """Track the target through the stream; raises RuntimeError when a
    frame's match is more than 2 px off.  Returns one dict a frame:
    ``found`` and ``truth`` (x, y), ``score``, the ROI ``top`` and the
    network input ``net_in`` (3, 224, 224) f32."""
    from ..models import Tracker

    frames, target, truth = make_stream(n_frames, h, w)
    roi_h = max(TARGET, 320 * h // 720)
    tracker = Tracker(target, frame_hw=(h, w), roi_h=roi_h, out_size=(224, 224))
    results = []
    for i, (nv, (tx, ty)) in enumerate(zip(frames, truth)):
        net_in, (x, y), score = tracker.step(nv)
        net_in = net_in[0].clone()  # kept past the tracker's next steps
        top = int(tracker.top_of(y))
        found = (int(x), int(y))
        print(f"frame {i}: target at {found} (truth {(tx, ty)}), score={float(score):.3f}, "
              f"roi_top={top}, net_in {tuple(net_in.shape)} "
              f"mean={float(net_in.mean()):+.4f}", flush=True)
        if abs(found[0] - tx) > 2 or abs(found[1] - ty) > 2:
            raise RuntimeError(f"frame {i}: tracker lost the target")
        results.append(dict(found=found, truth=(tx, ty), score=float(score), top=top,
                            net_in=net_in))
    print(f"tracked {len(frames)} frames, the fused NV kernel taking a moving top", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="moving-ROI camera tracking")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    args = ap.parse_args(argv)
    return track(args.frames, args.height, args.width)


if __name__ == "__main__":
    main()
