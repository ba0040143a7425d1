"""vacv_tpu_torch.entry and the examples against the JAX package.

``entry()`` on the CPU against ``__graft_entry__.entry()`` (cosine >=
1 - 1e-4, max-abs printed); ``dryrun_multichip`` in two gloo processes, in
this process for one device, and raising without cards;
``slam_frontend_config`` field by field; the tracking example small on the
CPU, its synthetic stream bit for bit the JAX example's at full size; the
SLAM front end's sharded output against ``pre.batch``.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as jentry
from examples import camera_tracking as j_camera_tracking
from vacv_tpu.models import slam_frontend_config as j_slam_frontend_config
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu_torch import config
from vacv_tpu_torch.entry import dryrun_multichip, entry
from vacv_tpu_torch.examples import camera_tracking, slam_frontend
from vacv_tpu_torch.models import slam_frontend_config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


@pytest.fixture(scope="module", autouse=True)
def _no_group_left():
    """Close a world of one that a test of this module started."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_entry_matches_the_jax_entry():
    fn, (batch,) = entry()
    assert batch.device.type == "cpu" and tuple(batch.shape) == (8, 720, 1280, 3)
    before = config.kernel_count("preprocess_fused_torch")
    out = fn(batch)
    assert config.kernel_count("preprocess_fused_torch") == before + 1
    jfn, jargs = jentry.entry()
    np.testing.assert_array_equal(np.asarray(jargs[0]), batch.numpy())
    want = np.asarray(jfn(*jargs))
    got = out.numpy()
    assert got.shape == want.shape == (8, 3, 224, 224)
    cos = cosine_similarity(got, want)
    print(f"vs JAX entry: 1-cos={1 - cos} max_abs={np.max(np.abs(got - want))}")
    assert cos >= 1 - 1e-4


def test_dryrun_multichip_in_two_cpu_processes():
    mean = dryrun_multichip(2, device="cpu")
    assert np.isfinite(mean) and abs(mean) < 1e-4  # normalized outputs average to 0
    assert not dist.is_initialized()


def test_dryrun_multichip_one_device_in_this_process():
    assert not dist.is_initialized()
    assert dryrun_multichip(1) == dryrun_multichip(1, device="cpu")
    assert not dist.is_initialized()  # the world of one it started is closed


def test_dryrun_multichip_without_cards_raises():
    """No fall back to the CPU unasked: the card is the default, and too
    few cards raise."""
    with config.device("cuda"), pytest.raises(RuntimeError, match="needs 2 CUDA cards"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="needs 1 CUDA cards"):
        dryrun_multichip(1, device="cuda")


def test_slam_frontend_config_matches_jax():
    got, want = slam_frontend_config(), j_slam_frontend_config()
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a.value if hasattr(a, "value") else a) == (b.value if hasattr(b, "value") else b), f.name


def test_tracking_stream_matches_the_jax_example():
    frames, target, truth = camera_tracking.make_stream()
    jframes, jtarget, jtops = j_camera_tracking.make_stream()
    np.testing.assert_array_equal(target, jtarget)
    assert [y for _, y in truth] == jtops
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)


def test_tracking_example_holds_its_target_on_the_cpu():
    names = ("yuv2bgr_torch", "match_corr_torch", "preprocess_fused_nv_torch")
    before = {k: config.kernel_count(k) for k in names}
    results = camera_tracking.main(["--frames", "3", "--height", "144", "--width", "256"])
    assert len(results) == 3
    for r in results:
        assert abs(r["found"][0] - r["truth"][0]) <= 2 and abs(r["found"][1] - r["truth"][1]) <= 2
        assert tuple(r["net_in"].shape) == (3, 224, 224) and r["net_in"].device.type == "cpu"
    assert {k: config.kernel_count(k) - before[k] for k in names} == dict.fromkeys(names, 3)
    with pytest.raises(ValueError):
        camera_tracking.make_stream(6, 60, 256)  # the target would leave the frame


def test_slam_frontend_example_shards_the_batch():
    pre, nv_batch, out = slam_frontend.main([])
    assert nv_batch.shape == (8, 1080, 1280)
    assert pre.describe_route(nv_batch.shape[1:]) == "fused_nv_torch"
    local = out.to_local()
    assert tuple(local.shape) == (8, 3, 224, 224) and torch.equal(local, pre.batch(nv_batch))
