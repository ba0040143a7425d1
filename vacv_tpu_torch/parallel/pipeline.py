"""Batch-of-frames sharded execution over a ``parallel.mesh`` mesh.

The counterpart of ``vacv_tpu/parallel/pipeline.py``.  A global batch is
split on its leading axis over the mesh's ``"data"`` dimension; each
process runs the per-image function over its own shard on its own
device.  Per-image ops need no collective; the cross-batch mean of a
per-image statistic is one ``all_reduce`` over the mesh's group.

Results are ``DTensor``s: the outputs ``Shard(0)`` (``to_local()`` is
this rank's shard, ``full_tensor()`` gathers the batch), the statistic
``Replicate()``.  JAX's ``vmap`` has no counterpart here:
``torch.vmap`` cannot pass through the kernels' ctypes wrappers, so the
shard's frames run one after another.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, batch_sharding, local_device, replicated


def put_sharded(batch, mesh, axis: str = DATA_AXIS):
    """This rank's slice of a global batch (numpy array or tensor), on
    this rank's device, as a ``DTensor`` sharded on the batch axis.
    Every rank passes the same global batch; the batch size must be a
    multiple of the mesh size (pad the tail batch)."""
    from torch.distributed.tensor import DTensor

    placements = batch_sharding(mesh, axis)
    n, size = len(batch), mesh.size()
    if n % size:
        raise ValueError(f"batch of {n} does not split over a mesh of {size}")
    per = n // size
    rank = mesh.get_local_rank(axis)
    part = batch[rank * per:(rank + 1) * per]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return DTensor.from_local(part.to(local_device(mesh)), mesh, placements, run_check=False)


def local_shard(batch, mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """This rank's frames: the local tensor of a sharded ``DTensor``, or
    the rank's slice of a global batch (``put_sharded``)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(batch, DTensor):
        batch = put_sharded(batch, mesh, axis)
    return batch.to_local()


def as_sharded(out: torch.Tensor, mesh, axis: str = DATA_AXIS):
    """This rank's outputs as its shard of a batch-sharded ``DTensor``.
    Every rank holds as many frames (``put_sharded`` splits evenly), so the
    global shape and its contiguous strides are given, not inferred
    (inferring them took ~23 µs of host time a call on an H100 host)."""
    from torch.distributed.tensor import DTensor

    shape = (out.shape[0] * mesh.size(), *out.shape[1:])
    stride, step = [], 1
    for d in reversed(shape):
        stride.insert(0, step)
        step *= d
    return DTensor.from_local(out, mesh, batch_sharding(mesh, axis), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def shard_batched(fn, mesh, axis: str = DATA_AXIS):
    """Lift a per-image ``fn(img) -> out`` into a batch function whose
    leading axis is sharded over ``mesh``: each rank runs ``fn`` over
    the frames of its shard and stacks the results."""

    def run(batch):
        local = local_shard(batch, mesh, axis)
        return as_sharded(torch.stack([fn(img) for img in local]), mesh, axis)

    return run


def shard_batched_with_stats(fn, mesh, axis: str = DATA_AXIS):
    """Like ``shard_batched``, for ``fn(img) -> (out, stat)``; also
    returns the mean of ``stat`` over the global batch, replicated.

    The local sum and the local count go over the group in one
    ``all_reduce(SUM)`` (the framework's only collective); the mean is
    total / count, as the JAX version divides its two ``psum``s."""
    from torch.distributed.tensor import DTensor

    def run(batch):
        local = local_shard(batch, mesh, axis)
        pairs = [fn(img) for img in local]
        outs = torch.stack([o for o, _ in pairs])
        stats = torch.stack([torch.as_tensor(s, device=outs.device) for _, s in pairs])
        total = stats.to(torch.float32).sum(dim=0)
        both = torch.cat([total.reshape(-1), total.new_tensor([float(len(pairs))])])
        dist.all_reduce(both, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
        mean = (both[:-1] / both[-1]).reshape(total.shape)
        return (as_sharded(outs, mesh, axis),
                DTensor.from_local(mean, mesh, replicated(mesh), run_check=False))

    return run
