"""vacv_tpu_torch.parallel against vacv_tpu.parallel.

The JAX package runs on its 8-virtual-device CPU mesh (tests/conftest.py),
the port in a world of one over gloo; the same numpy batches go through
both.  Sharded outputs match the JAX package at cosine >= 1 - 1e-4 (max-abs
printed) and the port's own unsharded output bit for bit; batch means agree
at rtol 1e-5.  A two-process gloo case runs this file as its worker
(``python tests/test_torch_parallel.py RANK N PORT``).
"""
import os
import re
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import vacv_tpu as vc
from vacv_tpu import config as jconfig
from vacv_tpu.models import PreprocessConfig as JConfig
from vacv_tpu.models import Preprocessor as JPre
from vacv_tpu.parallel import DATA_AXIS as J_DATA_AXIS
from vacv_tpu.parallel import make_mesh as j_make_mesh
from vacv_tpu.parallel import put_sharded as j_put_sharded
from vacv_tpu.parallel import shard_batched as j_shard_batched
from vacv_tpu.parallel import shard_batched_with_stats as j_shard_batched_with_stats
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import Layout, VRect
from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
from vacv_tpu_torch.parallel import (
    DATA_AXIS, batch_sharding, init_distributed, local_device, make_mesh, put_sharded,
    replicated, shard_batched, shard_batched_with_stats,
)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


@pytest.fixture(scope="module")
def mesh():
    """The port's world of one (gloo), destroyed with the module."""
    with config.device("cpu"):
        m = make_mesh()
    yield m
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return j_make_mesh()


def frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# (port config, JAX config, batch shape): test_parallel.py's cases.
CASES = {
    "resize": (PreprocessConfig(out_size=(16, 16)), JConfig(out_size=(16, 16)), (16, 36, 48, 3)),
    "crop_resize": (
        PreprocessConfig(crop_rect=VRect(4, 2, 52, 38), out_size=(24, 24), normalize=True),
        JConfig(crop_rect=vc.VRect(4, 2, 52, 38), out_size=(24, 24), normalize=True),
        (8, 40, 60, 3)),
}


def assert_matches_jax(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    cos = cosine_similarity(got, want)
    print(f"vs JAX: 1-cos={1 - cos} max_abs={np.max(np.abs(got - want))}")
    assert cos >= 1 - 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_shard_batched_matches_jax_and_the_unsharded_chain(name, mesh, jmesh):
    cfg, jcfg, shape = CASES[name]
    batch = frames(1, shape)
    pre, jpre = Preprocessor(cfg), JPre(jcfg)
    out = shard_batched(pre.fn, mesh)(put_sharded(batch, mesh))
    want = j_shard_batched(jpre.fn, jmesh)(j_put_sharded(batch, jmesh))
    assert out.placements == tuple(batch_sharding(mesh))
    assert torch.equal(out.to_local(), torch.stack([pre.fn(f) for f in batch]))
    assert_matches_jax(out.full_tensor(), want)


def test_shard_batched_with_stats_matches_jax(mesh, jmesh):
    """test_parallel.py's per-image (x * 2, mean(x)): outputs exact, the
    all-reduced mean at rtol 1e-5 against the JAX psum and numpy."""
    batch = frames(2, (8, 8, 8, 3)).astype(np.float32)
    outs, mean = shard_batched_with_stats(lambda x: (x * 2.0, x.mean()), mesh)(
        put_sharded(batch, mesh))
    jouts, jmean = j_shard_batched_with_stats(lambda x: (x * 2.0, jnp.mean(x)), jmesh)(
        j_put_sharded(batch, jmesh))
    np.testing.assert_array_equal(outs.to_local().numpy(), batch * 2.0)
    np.testing.assert_array_equal(np.asarray(jouts), batch * 2.0)
    assert mean.placements == tuple(replicated(mesh))
    np.testing.assert_allclose(float(mean.to_local()), float(jmean), rtol=1e-5)
    np.testing.assert_allclose(float(mean.to_local()), batch.mean(), rtol=1e-5)


def test_shard_batched_with_stats_over_the_pipeline(mesh, jmesh):
    """pre.fn with a vector statistic (each frame's channel means)."""
    cfg, jcfg, shape = CASES["crop_resize"]
    batch = frames(3, shape)
    pre, jpre = Preprocessor(cfg), JPre(jcfg)
    outs, mean = shard_batched_with_stats(
        lambda x: (pre.fn(x), x.float().mean(dim=(0, 1))), mesh)(batch)
    jouts, jmean = j_shard_batched_with_stats(
        lambda x: (jpre.fn(x), jnp.mean(x.astype(jnp.float32), axis=(0, 1))), jmesh)(
        j_put_sharded(batch, jmesh))
    assert torch.equal(outs.to_local(), torch.stack([pre.fn(f) for f in batch]))
    assert_matches_jax(outs.full_tensor(), jouts)
    np.testing.assert_allclose(mean.to_local().numpy(), np.asarray(jmean), rtol=1e-5)
    np.testing.assert_allclose(mean.to_local().numpy(), batch.mean(axis=(0, 1, 2)), rtol=1e-5)


def test_batched_runs_the_fused_route_once_and_matches_jax(mesh, jmesh):
    """test_parallel.py's kernel case: the JAX fused kernel (interpret
    mode) under shard_map against the port's fused route on the shard."""
    batch = frames(4, (16, 64, 128, 3))
    rect, out_size = (8, 8, 8 + 112, 8 + 48), (32, 32)
    pre = Preprocessor(PreprocessConfig(crop_rect=VRect(*rect), out_size=out_size,
                                        out_layout=Layout.CHW, normalize=True))
    assert pre.describe_route(batch.shape[1:]) == "fused_torch"
    before = config.kernel_count("preprocess_fused_torch")
    out = pre.batched(mesh)(put_sharded(batch, mesh))
    assert config.kernel_count("preprocess_fused_torch") == before + 1
    assert out.placements == tuple(batch_sharding(mesh))
    assert out.to_local().device == local_device(mesh)
    assert torch.equal(out.to_local(), pre.batch(batch))
    with jconfig.backend("pallas"):
        jpre = JPre(JConfig(crop_rect=vc.VRect(*rect), out_size=out_size,
                            out_layout=vc.CHW, normalize=True))
        want = jpre.batched(jmesh)(j_put_sharded(batch, jmesh))
    assert_matches_jax(out.full_tensor(), want)
    # a global numpy batch is sharded on the way in
    assert torch.equal(pre.batched(mesh)(batch).to_local(), out.to_local())


@pytest.mark.parametrize("as_tensor", [False, True])
def test_put_sharded_places_the_shards(mesh, jmesh, as_tensor):
    batch = frames(5, (8, 16, 16, 3))
    arr = j_put_sharded(batch, jmesh)
    assert len(arr.addressable_shards) == 8
    d = put_sharded(torch.from_numpy(batch) if as_tensor else batch, mesh)
    assert d.placements == tuple(batch_sharding(mesh))
    assert tuple(d.shape) == batch.shape
    # a world of one holds the whole batch as its shard
    assert d.to_local().device == torch.device("cpu")
    np.testing.assert_array_equal(d.to_local().numpy(), batch)
    np.testing.assert_array_equal(np.asarray(arr.addressable_shards[0].data),
                                  d.to_local().numpy()[:1])


def test_put_sharded_rejects_an_indivisible_batch():
    """A batch must split evenly over the mesh (the JAX version requires it
    too); a stand-in mesh of two ranks, as the two-process case has."""
    two = types.SimpleNamespace(mesh_dim_names=(DATA_AXIS,), size=lambda: 2,
                                get_local_rank=lambda axis=None: 0, device_type="cpu")
    with pytest.raises(ValueError, match="does not split"):
        put_sharded(frames(6, (5, 8, 8, 3)), two)


def test_mesh_helpers(mesh):
    assert DATA_AXIS == J_DATA_AXIS == "data"
    assert mesh.mesh_dim_names == (DATA_AXIS,) and mesh.size() == 1
    assert dist.get_backend() == "gloo"
    assert local_device(mesh) == torch.device("cpu")
    assert [type(p).__name__ for p in batch_sharding(mesh)] == ["Shard"]
    assert batch_sharding(mesh)[0].dim == 0
    assert [type(p).__name__ for p in replicated(mesh)] == ["Replicate"]
    with pytest.raises(ValueError):
        batch_sharding(mesh, axis="model")
    with pytest.raises(ValueError):
        make_mesh(["cpu", "cuda"])
    with pytest.raises(ValueError):
        make_mesh(["cpu", "cpu"])  # two devices for a group of one
    init_distributed(None, 1, 0)  # one process: nothing to join
    init_distributed()


def test_make_mesh_asks_for_a_card_when_there_is_none():
    """The card is the default: with no card and no request for the CPU,
    make_mesh raises before it starts or joins a group."""
    with config.device("cuda"), pytest.raises(RuntimeError, match=r'config\.device\("cpu"\)'):
        make_mesh()
    with pytest.raises(RuntimeError, match=r'config\.device\("cpu"\)'):
        make_mesh(["cuda"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER_BATCH = (8, 32, 32, 3)


def worker_preprocessor():
    return Preprocessor(PreprocessConfig(crop_rect=VRect(2, 2, 30, 30), out_size=(16, 16),
                                         out_layout=Layout.CHW, normalize=True))


def test_two_process_gloo_pipeline():
    """Two processes join one gloo group: each rank's shard equals
    ``pre.batch`` of its slice, both print the same all-reduced mean, and
    an indivisible batch raises on both."""
    port = _free_port()
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=root)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    means = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        m = re.search(rf"^DIST_OK {rank} (\S+)$", out, re.M)
        assert m, f"rank {rank} printed no DIST_OK line:\n{out}"
        means.append(float(m.group(1)))
    assert means[0] == means[1]
    batch = frames(7, WORKER_BATCH)
    np.testing.assert_allclose(means[0], batch.mean(), rtol=1e-5)


def _worker(rank: int, n: int, port: int) -> None:
    config.set_default_device("cpu")
    init_distributed(f"127.0.0.1:{port}", n, rank)
    mesh = make_mesh()
    assert mesh.size() == n and mesh.get_local_rank() == rank
    batch = frames(7, WORKER_BATCH)  # the same global batch on every rank
    per = len(batch) // n
    mine = batch[rank * per:(rank + 1) * per]
    pre = worker_preprocessor()
    out = pre.batched(mesh)(put_sharded(batch, mesh))
    if tuple(out.shape) != (len(batch), 3, 16, 16) or not torch.equal(out.to_local(),
                                                                       pre.batch(mine)):
        raise SystemExit(f"rank {rank}: batched shard differs from pre.batch of its slice")
    outs, mean = shard_batched_with_stats(lambda x: (pre.fn(x), x.float().mean()), mesh)(batch)
    if not torch.equal(outs.to_local(), torch.stack([pre.fn(f) for f in mine])):
        raise SystemExit(f"rank {rank}: shard_batched_with_stats shard differs")
    try:
        put_sharded(batch[:5], mesh)
    except ValueError:
        pass
    else:
        raise SystemExit(f"rank {rank}: put_sharded took a batch of 5 over 2 ranks")
    print(f"DIST_OK {rank} {float(mean.to_local())!r}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(*map(int, sys.argv[1:4]))
