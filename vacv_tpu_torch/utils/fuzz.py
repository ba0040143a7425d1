"""Seeded inputs for sweeps that hold a kernel to its plain version (the
card-only tests, the CPU tests against the JAX package, ``chip_smoke.py``)."""
from __future__ import annotations

import numpy as np


def affine_matrices(seed: int, h: int, w: int, h_out: int, w_out: int, n: int) -> list:
    """``n`` seeded inverse maps (2x3 float32) from an h_out x w_out output
    into an h x w source: any rotation, a scale of 0.3 to 3 per axis, a flip
    half of the time, and a translation that puts the output's centre up to
    three quarters of the source's size off the source's centre, so the
    output overshoots the source past both edges."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.uniform(-np.pi, np.pi)
        scale = np.exp(rng.uniform(np.log(0.3), np.log(3.0), 2))
        lin = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]) @ np.diag(
            [scale[0] * rng.choice([-1.0, 1.0]), scale[1]])
        centre = np.array([w / 2, h / 2]) + rng.uniform(-0.75, 0.75, 2) * np.array([w, h])
        t = centre - lin @ np.array([w_out / 2, h_out / 2])
        out.append(np.concatenate([lin, t[:, None]], axis=1).astype(np.float32))
    return out
