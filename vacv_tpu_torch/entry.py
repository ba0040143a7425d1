"""Entry points: the flagship step and a multi-device dry run.

The counterpart of ``__graft_entry__.py``.  ``entry()`` returns the
config-4 batch function and its example batch; ``dryrun_multichip(n)``
runs the sharded per-image pipeline with an all-reduced batch mean over
a mesh of ``n`` devices, one process per device.

On the card it needs ``n`` cards and raises RuntimeError with fewer; it
never moves to the CPU unasked (the JAX version falls back to virtual
CPU devices).  ``device="cpu"`` (or a ``config.device("cpu")`` context)
runs ``n`` gloo processes on the CPU.
"""
from __future__ import annotations

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import config

_OK = re.compile(r"^dryrun_multichip ok: rank (\d+) of (\d+).* batch-mean (\S+)$", re.M)
_TIMEOUT = 300  # seconds for the worker processes of one dry run


def entry():
    """(fn, example_args) of the flagship step: the fused SLAM front-end
    preprocess (BASELINE config 4) on a batch of eight 720p frames —
    crop → bilinear resize → CHW → f32 → per-image normalize — on the
    default device."""
    from .core.image import as_tensor
    from .core.types import Layout, VRect
    from .models import PreprocessConfig, Preprocessor

    pre = Preprocessor(PreprocessConfig(
        crop_rect=VRect(16, 8, 1264, 712),
        out_size=(224, 224),
        out_layout=Layout.CHW,
        normalize=True,
    ))
    batch = as_tensor(np.random.default_rng(0).integers(0, 256, size=(8, 720, 1280, 3),
                                                        dtype=np.uint8), pre.device)
    return pre.batch_fn, (batch,)


def _step(n_devices: int) -> float:
    """One sharded step over the mesh of this process's group: the
    per-image pipeline and its all-reduced batch mean on two 32x32
    frames a device.  Returns the batch mean."""
    from .core.types import Layout, VRect
    from .models import PreprocessConfig, Preprocessor
    from .parallel import local_device, make_mesh, put_sharded, shard_batched_with_stats

    mesh = make_mesh()
    if mesh.size() != n_devices:
        raise RuntimeError(f"the process group holds {mesh.size()} devices, not {n_devices}")
    dev = local_device(mesh)
    pre = Preprocessor(PreprocessConfig(crop_rect=VRect(2, 2, 30, 30), out_size=(16, 16),
                                        out_layout=Layout.CHW, normalize=True), device=dev)

    def per_image(x):
        out = pre.fn(x)
        return out, out.mean()

    step = shard_batched_with_stats(per_image, mesh)
    batch = np.random.default_rng(0).integers(0, 256, size=(2 * n_devices, 32, 32, 3),
                                              dtype=np.uint8)
    outs, stat = step(put_sharded(batch, mesh))
    local = outs.to_local()
    rank = mesh.get_local_rank()
    if tuple(outs.shape) != (2 * n_devices, 3, 16, 16) or tuple(local.shape) != (2, 3, 16, 16):
        raise RuntimeError(f"sharded output {tuple(outs.shape)}, local {tuple(local.shape)}")
    if local.device != dev:
        raise RuntimeError(f"rank {rank}'s shard lies on {local.device}, not {dev}")
    want = torch.stack([pre.fn(f) for f in batch[2 * rank:2 * rank + 2]])
    if not torch.equal(local, want):
        raise RuntimeError(f"rank {rank}'s shard differs from the per-image pipeline")
    mean = float(stat.to_local())
    print(f"dryrun_multichip ok: rank {rank} of {n_devices} {dev.type} devices, "
          f"out {tuple(outs.shape)}, batch-mean {mean!r}", flush=True)
    return mean


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n_devices: int, kind: str) -> float:
    """Run the step in ``n_devices`` processes that join one group on a
    local port; every rank must pass and print the same batch mean."""
    port = _free_port()
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vacv_tpu_torch.entry", str(rank), str(n_devices), str(port),
         kind],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(n_devices)]
    try:
        outs = [p.communicate(timeout=_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    means = {}
    for rank, (p, out) in enumerate(zip(procs, outs)):
        m = _OK.search(out)
        if p.returncode != 0 or m is None:
            raise RuntimeError(f"dryrun rank {rank} failed (exit {p.returncode}):\n{out}")
        means[rank] = float(m.group(3))
    if len(set(means.values())) != 1:
        raise RuntimeError(f"the ranks disagree on the batch mean: {means}")
    return means[0]


def dryrun_multichip(n_devices: int, device=None) -> float:
    """Build an ``n_devices`` mesh, run the sharded preprocess step with
    its all-reduced batch mean (data-parallel frame sharding, the
    framework's scale-out axis) on tiny shapes, check each shard, and
    return the batch mean.

    A process group of ``n_devices`` that is already running (a
    distributed launch) runs the step in this process, and so does one
    device with no group (a world of one, closed again after the step);
    otherwise ``n_devices`` worker processes run it."""
    kind = torch.device(device if device is not None else config.default_device()).type
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards, "
                           f"PyTorch sees {torch.cuda.device_count()}; ask for the CPU with "
                           f'device="cpu"')
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        with config.device(kind):
            return _step(n_devices)
    if n_devices == 1 and not dist.is_initialized():
        with config.device(kind):
            try:
                return _step(1)
            finally:
                dist.destroy_process_group()
    return _spawn(n_devices, kind)


def _worker(rank: int, n_devices: int, port: int, kind: str) -> None:
    """One rank of ``_spawn``: ``python -m vacv_tpu_torch.entry RANK N PORT
    DEVICE``."""
    from .parallel import init_distributed

    config.set_default_device(kind)
    init_distributed(f"127.0.0.1:{port}", n_devices, rank)
    try:
        _step(n_devices)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
