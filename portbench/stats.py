"""Order statistics over all samples, and the seeded draws the loops share."""
from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) of all ``values`` by nearest
    rank: the smallest value with at least q% of the samples at or below
    it.  A missing sample (``inf``) counts as the largest."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of no samples")
    return float(ordered[max(math.ceil(q / 100 * len(ordered)) - 1, 0)])


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A host generator for one purpose of one run, from ``--seed``."""
    return np.random.default_rng([int(seed), *salt])


def sample_positions(seed: int, mean_gap: float, limit: int = 1 << 22) -> list[int]:
    """Indices of the outputs a run keeps for the check: gaps drawn
    uniformly from [1, 2 mean_gap) from the seed, the first within one gap."""
    r = rng(seed, 7)
    gaps = r.integers(1, max(int(2 * mean_gap), 2), size=int(limit // max(mean_gap, 1)) + 1)
    pos = np.cumsum(gaps) - 1
    return [int(p) for p in pos[pos < limit]]


def arrival_schedule(seed: int, cameras: int, fps: float, jitter_s: float, seconds: float):
    """(due time in s, camera) of every frame due in [0, seconds), sorted.

    Camera c sends at ``phase_c + k / fps + jitter``.  The phases are the
    cameras' even shares of one period, dealt to the cameras in an order
    drawn from the seed, and the jitter is uniform in ``[-jitter_s,
    jitter_s]``, drawn per frame: every seed offers the same load with
    other collisions."""
    r = rng(seed, 11)
    period = 1.0 / fps
    phases = r.permutation(cameras) * (period / cameras)
    k = np.arange(int(math.ceil(seconds * fps)) + 1)
    due = phases[:, None] + k[None, :] * period
    due = due + r.uniform(-jitter_s, jitter_s, size=due.shape)
    cams = np.broadcast_to(np.arange(cameras)[:, None], due.shape)
    keep = (due >= 0) & (due < seconds)
    order = np.argsort(due[keep], kind="stable")
    return due[keep][order], cams[keep][order]
