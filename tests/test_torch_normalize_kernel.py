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
from vacv_tpu_torch.ops.cuda.normalize import Limits, launch_plan, normalize_fused
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


# ---- the kernel's launch plan (what cannot run here: the CUDA launch) ----

# An H100's numbers as ``vacv_normalize_limits`` reports them: 132 SMs,
# 227 KB of opt-in shared memory less the kernel's own, one resident
# 1024-thread block an SM, 512 x 16-element cluster blocks, clusters of 8.
H100 = Limits(sms=132, smem_bytes=231936, blocks_per_sm=1, cluster_threads=512,
              cluster_items=16, max_cluster=8, grid_threads=1024)
SMALL_CARD = Limits(sms=4, smem_bytes=4096, blocks_per_sm=2, cluster_threads=64,
                    cluster_items=16, max_cluster=4, grid_threads=128)
PLANE_SIZES = [1, 2, 3, 5, 15, 16, 17, 127, 2257, 4099, 50176, 65521, 65536, 65537, 131071,
               999983, 1080 * 1920]


def owners(plan, planes, plane, itemsize, shift, lim):
    """How many times the plan's blocks take each element, by the kernel's
    own index rules (csrc/normalize.cu), as an array of counts; ``shift``
    is how many elements the input starts above a 16-byte boundary."""
    count = np.zeros(planes * plane, np.int64)
    if plan.form == "cluster":
        unit = 4                      # the cluster form's quads, from a 4-element boundary
        shift %= 4
        per_thread = lim.cluster_items // unit
        slots = np.arange(plan.cluster * plan.threads * per_thread)  # rank, thread and step
        for p in range(planes):
            lo, hi = p * plane + shift, (p + 1) * plane + shift
            j = (lo // unit + slots)[:, None] * unit + np.arange(unit)   # unit space
            j = j[(j >= lo) & (j < hi)]
            np.add.at(count, j - shift, 1)
        return count
    assert plan.grid % plan.per_plane == 0
    for item in range(plan.rounds * plan.grid):   # block b of round r takes item r * grid + b
        p, s = divmod(item, plan.per_plane)
        if p >= planes:
            continue
        plane_lo, plane_hi = p * plane + shift, (p + 1) * plane + shift
        base = plane_lo // 16 * 16 + s * plan.slice
        lo = min(max(plane_lo - base, 0), plan.slice) + base
        hi = min(max(plane_hi - base, 0), plan.slice) + base
        if hi > lo:
            count[lo - shift:hi - shift] += 1
    return count


@pytest.mark.parametrize("lim", [H100, SMALL_CARD], ids=["h100", "small"])
@pytest.mark.parametrize("itemsize", [4, 1], ids=["f32", "u8"])
@pytest.mark.parametrize("plane", PLANE_SIZES)
def test_launch_plan_gives_every_element_to_exactly_one_block(lim, itemsize, plane):
    for planes, shift in [(1, 0), (3, 0), (3, 16 // itemsize - 1), (7, 1), (300, 2)]:
        if planes * plane > 8_000_000:
            planes = 3
        plan = launch_plan(planes, plane, itemsize, lim)
        assert (owners(plan, planes, plane, itemsize, shift, lim) == 1).all()
        if plan.form == "cluster":
            assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= lim.max_cluster
            assert plan.grid == planes * plan.cluster and plan.grid % plan.cluster == 0
            assert plan.scratch == 0 and plan.threads == lim.cluster_threads
        else:
            assert 1 <= plan.grid <= lim.sms * lim.blocks_per_sm       # every block resident
            assert plan.grid % plan.per_plane == 0                     # a plane meets at one barrier
            assert plan.rounds * (plan.grid // plan.per_plane) >= planes
            assert plan.slice % 16 == 0 and plan.cap % 16 == 0 and 0 < plan.cap <= plan.slice
            assert plan.smem_bytes == plan.cap * itemsize <= lim.smem_bytes
            assert plan.scratch == 4 * planes * plan.per_plane         # part[plane][slice]
            assert plan.threads == lim.grid_threads


def test_launch_plan_forms_at_the_main_paths_shapes():
    """(3, 224, 224) is one cluster of 8 a plane, no scratch; 1080p is one
    block an SM with its whole slice in shared memory."""
    for itemsize in (4, 1):
        small = launch_plan(3, 224 * 224, itemsize, H100)
        assert (small.form, small.cluster, small.grid, small.scratch) == ("cluster", 8, 24, 0)
        big = launch_plan(3, 1080 * 1920, itemsize, H100)
        assert (big.form, big.grid, big.per_plane, big.rounds) == ("grid", 132, 44, 1)
        assert big.cap == big.slice
    k4 = launch_plan(3, 2160 * 3840, 4, H100)    # 99.5 MB: the slices' tails are read again
    assert k4.form == "grid" and k4.cap < k4.slice and k4.smem_bytes <= H100.smem_bytes
    many = launch_plan(300, 70_000, 4, H100)        # more planes than resident blocks: rounds
    assert (many.per_plane, many.grid, many.rounds) == (1, 132, 3)


def test_launch_plan_forced_forms_and_refusals():
    assert launch_plan(3, 224 * 224, 4, H100, "grid").form == "grid"
    assert launch_plan(3, 224 * 224, 4, H100, "cluster").form == "cluster"
    with pytest.raises(ValueError, match="does not fit"):
        launch_plan(3, 1080 * 1920, 4, H100, "cluster")
    with pytest.raises(ValueError, match="form"):
        launch_plan(3, 64, 4, H100, "triton")
    with pytest.raises(ValueError):
        launch_plan(0, 64, 4, H100)
    with pytest.raises(ValueError, match="form"):
        normalize_fused(torch.zeros((1, 2, 2)), form="triton")


def test_a_cuda_request_without_a_card_raises():
    """No fallback: with no card the wrapper's CUDA path cannot be reached
    by a CPU tensor, and a CUDA tensor cannot be made."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        normalize_fused(torch.zeros((1, 2, 2), device="cuda"))
