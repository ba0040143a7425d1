"""The standalone normalize route against vacv_tpu's normalize kernel.

``normalize_fused`` on a CPU tensor runs the plain version
(``normalize_torch``, what the CUDA kernel is held to on the card); it
gets the same numpy planes as the JAX ``normalize_fused_pallas`` in
interpret mode, including the case where the JAX kernel is forced to
merge many chunks.  Float32 sums run in another order in the two
packages: the bar is 1e-4 absolute on normalized values (the JAX
package's own bar, tests/test_normalize.py:105), 1e-3 against a float64
oracle.  The dispatcher ``normalize`` routes as the JAX one does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu import config as jconfig
from vacv_tpu.ops.pallas import normalize as pn
from vacv_tpu_torch import config
from vacv_tpu_torch.ops.cuda.normalize import normalize_fused
from vacv_tpu_torch.ops.normalize import normalize_torch


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield



def planes(seed, shape, dtype):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8).astype(dtype)


def jax_kernel(x):
    with jconfig.backend("pallas"):
        return np.asarray(pn.normalize_fused_pallas(vc.Image(jnp.asarray(x), vc.CHW)).data)


@pytest.mark.parametrize("shape", [(3, 144, 176), (3, 224, 224), (5, 37, 64)])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_plain_route_matches_jax_kernel(shape, dtype):
    x = planes(0, shape, dtype)
    k0, p0 = config.kernel_count("normalize_fused"), config.kernel_count("normalize_fused_torch")
    got = normalize_fused(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), jax_kernel(x), atol=1e-4, rtol=1e-4)
    assert config.kernel_count("normalize_fused_torch") == p0 + 1
    assert config.kernel_count("normalize_fused") == k0


def test_matches_jax_kernel_forced_to_many_chunks():
    """Shrink the JAX kernel's chunk budget so a small frame merges 4+
    chunk partials (as tests/test_normalize.py:108-144 does), and hold
    both to a float64 oracle."""
    x = planes(1, (3, 200, 128), np.uint8)
    old = pn._CHUNK_BUDGET
    pn._CHUNK_BUDGET = 64 * 1024
    pn._call_chw._clear_cache()
    try:
        assert pn._chunk_rows(200, 128) < 200
        want = jax_kernel(x)
    finally:
        pn._CHUNK_BUDGET = old
        pn._call_chw._clear_cache()
    got = normalize_fused(torch.from_numpy(x)).numpy()
    f = x.astype(np.float64)
    oracle = (f - f.mean(axis=(1, 2), keepdims=True)) / (f.std(axis=(1, 2), keepdims=True) + 1e-6)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, oracle, atol=1e-3)


def test_dispatcher_routes_chw_float_self_stats():
    """``config.use_fused()``, both stats None, rank 3, CHW, not u8 → the
    wrapper; everything else → normalize_torch, uncounted."""
    x = planes(2, (3, 24, 40), np.float32)
    chw = vt.Image(torch.from_numpy(x), vt.CHW)
    p0 = config.kernel_count("normalize_fused_torch")
    got = vt.normalize(chw)
    assert config.kernel_count("normalize_fused_torch") == p0 + 1
    torch.testing.assert_close(got.data, normalize_torch(chw).data, rtol=0, atol=0)
    assert got.layout == vt.CHW
    for img, mean, std in [
        (chw, (1.0, 2.0, 3.0), None),
        (chw, None, (1.0, 2.0, 3.0)),
        (vt.Image(torch.from_numpy(np.ascontiguousarray(x.transpose(1, 2, 0))), vt.HWC), None, None),
        (vt.Image(torch.from_numpy(x.astype(np.uint8)), vt.CHW), None, None),
        (vt.Image(torch.from_numpy(x[0]), vt.CHW), None, None),
    ]:
        vt.normalize(img, mean, std)
    with config.backend("torch"):
        vt.normalize(chw)
    assert config.kernel_count("normalize_fused_torch") == p0 + 1


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_dispatcher_converts_other_floats_to_f32(dtype):
    x = torch.from_numpy(planes(3, (3, 16, 20), np.float32)).to(dtype)
    got = vt.normalize(vt.Image(x, vt.CHW)).data
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, normalize_torch(vt.Image(x, vt.CHW)).data, rtol=0, atol=0)
