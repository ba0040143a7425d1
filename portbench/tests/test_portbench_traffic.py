"""The load generator's draws: fixed by the seed, at the stated rate."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import stats

SEED = 2**31 + 12345


def test_arrivals_are_fixed_by_the_seed():
    a = stats.arrival_schedule(SEED, 16, 30.0, 2e-3, 5.0)
    b = stats.arrival_schedule(SEED, 16, 30.0, 2e-3, 5.0)
    c = stats.arrival_schedule(SEED + 1, 16, 30.0, 2e-3, 5.0)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


@pytest.mark.parametrize("cameras,fps,seconds", [(16, 30.0, 15.0), (40, 30.0, 4.0), (3, 25.0, 2.0)])
def test_arrivals_come_at_the_stated_rate(cameras, fps, seconds):
    due, cams = stats.arrival_schedule(SEED, cameras, fps, 2e-3, seconds)
    assert abs(len(due) - cameras * fps * seconds) <= cameras
    assert np.all(np.diff(due) >= 0) and due[0] >= 0 and due[-1] < seconds
    per_camera = np.bincount(cams, minlength=cameras)
    assert per_camera.max() - per_camera.min() <= 1
    for c in range(cameras):
        gaps = np.diff(due[cams == c])
        assert np.all(np.abs(gaps - 1 / fps) <= 4e-3 + 1e-9)  # one period, +-2 ms jitter each end


def test_every_seed_offers_the_same_phases():
    a, _ = stats.arrival_schedule(1, 10, 30.0, 0.0, 1.0)
    b, _ = stats.arrival_schedule(2, 10, 30.0, 0.0, 1.0)
    assert np.allclose(a, b)


def test_sample_positions_fixed_by_the_seed_and_spread():
    a = stats.sample_positions(SEED, 100)
    assert a == stats.sample_positions(SEED, 100)
    assert a != stats.sample_positions(SEED + 1, 100)
    gaps = np.diff(a)
    assert gaps.min() >= 1 and gaps.max() < 200 and abs(gaps.mean() - 100) < 5
