"""Percentiles are taken over all samples."""
from __future__ import annotations

import math

import numpy as np
import pytest

from portbench import stats


@pytest.mark.parametrize("q", [50, 90, 95, 99])
@pytest.mark.parametrize("n", [1, 7, 100, 10001])
def test_percentile_is_the_nearest_rank_over_all_samples(q, n):
    values = np.random.default_rng(n).exponential(size=n)
    assert stats.percentile(list(values), q) == np.percentile(values, q, method="inverted_cdf")


def test_a_missing_sample_counts_as_the_largest():
    values = [1.0] * 95 + [math.inf] * 5
    assert stats.percentile(values, 95) == 1.0
    assert stats.percentile(values + [math.inf], 95) == math.inf


def test_one_slow_sample_in_twenty_sets_the_95th_of_twenty():
    assert stats.percentile([1.0] * 19 + [9.0], 95) == 1.0
    assert stats.percentile([1.0] * 18 + [9.0, 9.0], 95) == 9.0
