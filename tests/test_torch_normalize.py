"""vacv_tpu_torch mean_stddev / normalize against vacv_tpu's jnp route.

Population σ around the image's own mean, ε in the denominator, and a
partially supplied (mean, stddev) pair honoured.  Float32 sums run in
another order in the two packages: the bar is 1e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu.ops.normalize import normalize_jnp
from vacv_tpu_torch.ops.normalize import normalize_planes, normalize_torch

MEAN = (104.0, 117.0, 123.0)
STD = (57.1, 57.4, 58.4)


def _img(layout, dtype, seed=0, shape=(40, 56, 3)):
    a = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8).astype(dtype)
    if layout == "CHW" and a.ndim == 3:
        a = np.ascontiguousarray(a.transpose(2, 0, 1))
    return a


@pytest.mark.parametrize("layout", ["HWC", "CHW"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_mean_stddev_matches(layout, dtype):
    a = _img(layout, dtype)
    jm, js = vc.mean_stddev(vc.Image(jnp.asarray(a), vc.Layout(layout)))
    tm, ts = vt.mean_stddev(vt.Image(torch.from_numpy(a), vt.Layout(layout)))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


STATS = {
    "self": (None, None),
    "static": (MEAN, STD),
    "mean_only": (MEAN, None),
    "stddev_only": (None, STD),
    "scalar": (110.0, 55.0),
}


@pytest.mark.parametrize("stats", list(STATS))
@pytest.mark.parametrize("layout", ["HWC", "CHW"])
def test_normalize_matches(stats, layout):
    mean, std = STATS[stats]
    a = _img(layout, np.float32, seed=1)
    j = normalize_jnp(vc.Image(jnp.asarray(a), vc.Layout(layout)), mean, std)
    t = vt.normalize(vt.Image(torch.from_numpy(a), vt.Layout(layout)), mean, std)
    assert t.dtype == torch.float32 and t.layout == vt.Layout(layout)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.data), rtol=1e-5, atol=1e-5)


def test_normalize_u8_and_gray():
    a = _img("HWC", np.uint8, seed=2)
    j = normalize_jnp(a)
    t = normalize_torch(a)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.data), rtol=1e-5, atol=1e-5)
    g = a[..., 0]
    np.testing.assert_allclose(normalize_torch(g).numpy(),
                               np.asarray(normalize_jnp(g).data), rtol=1e-5, atol=1e-5)


def test_normalize_planes_batched_is_per_frame():
    """The batched (N, C, H, W) form the fused route uses equals the
    per-image normalize of each frame."""
    x = torch.from_numpy(np.random.default_rng(3).normal(90, 30, (3, 3, 9, 11)).astype(np.float32))
    out = normalize_planes(x, MEAN, None)
    for i in range(3):
        want = normalize_torch(vt.Image(x[i], vt.CHW), MEAN, None).data
        torch.testing.assert_close(out[i], want, rtol=0, atol=0)
