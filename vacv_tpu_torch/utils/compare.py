"""Correctness metric — cosine similarity between images.

Parity with ``ImageUtil::compare_image_data`` (reference
``src/util/image_util.h:15-32``): cosine =
``dot / sqrt(norm1 * norm2)`` with 1e-6 epsilon seeds on each
accumulator.  Computed in float64 on host for metric stability (the
reference uses double accumulators too).
"""
from __future__ import annotations

import numpy as np

# The reference passes a test when |cosine - 1.0| <= 5e-4
# (cv_profile.cpp:10).  Our bar is tighter per BASELINE.md.
REF_MAX_DIFF = 5e-4
MAX_DIFF = 1e-4


def cosine_similarity(a, b) -> float:
    """Cosine similarity of two arrays of identical shape."""
    x = np.asarray(a, dtype=np.float64).ravel()
    y = np.asarray(b, dtype=np.float64).ravel()
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {x.shape} vs {y.shape}")
    dot = float(np.dot(x, y)) + 1e-6
    n1 = float(np.dot(x, x)) + 1e-6
    n2 = float(np.dot(y, y)) + 1e-6
    return dot / np.sqrt(n1 * n2)


def passes(cosine: float, max_diff: float = MAX_DIFF) -> bool:
    return abs(cosine - 1.0) <= max_diff
