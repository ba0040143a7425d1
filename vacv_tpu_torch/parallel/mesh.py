"""Device mesh and multi-process bootstrap on ``torch.distributed``.

The counterpart of ``vacv_tpu/parallel/mesh.py``.  The scale-out axis is
batch data parallelism over frames: a 1-D ``DeviceMesh`` whose single
``"data"`` dimension spans the processes of the group, one process per
card (PyTorch's idiom; JAX puts every local chip in one process).
Per-image preprocessing needs no collective; a cross-batch statistic,
where asked for, is one ``all_reduce`` (``parallel/pipeline.py``).

Backends: NCCL for the card, gloo when the caller asks for the CPU
(``config.device("cpu")`` or ``device="cpu"``).  With no process group
yet, ``make_mesh`` starts a world of one over an in-process
``HashStore``, so one card (or one CPU process) needs no coordinator.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import config

DATA_AXIS = "data"


def _device_type(device=None) -> str:
    """"cuda" or "cpu": ``device``, else the default device; the card
    raises when there is none (``config.input_device``)."""
    return config.input_device(device).type


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join a group of ``num_processes`` processes at ``coordinator``
    (``"host:port"``) as rank ``process_id``.  No-op for one process.

    On the card (the default device), each process takes card
    ``process_id % device_count`` (set before any CUDA work) and the group
    runs NCCL; when the caller asked for the CPU it runs gloo."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("init_distributed needs a coordinator and a process_id")
    kind = _device_type()
    if kind == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def make_mesh(devices=None, axis: str = DATA_AXIS):
    """1-D mesh over the processes of the group, one device each.

    ``devices``: one ``torch.device`` (or name) per rank, all of one
    type; by default the default device's type on every rank.  With no
    process group, a world of one is started here (NCCL on the card,
    gloo on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    kinds = {torch.device(d).type for d in devices} if devices is not None else set()
    if len(kinds) > 1:
        raise ValueError(f"a mesh takes devices of one type, got {sorted(kinds)}")
    kind = _device_type(kinds.pop() if kinds else None)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if devices is not None and len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a group of {n} processes")
    return init_device_mesh(kind, (n,), mesh_dim_names=(axis,))


def local_device(mesh) -> torch.device:
    """This process's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_axis(mesh, axis: str) -> None:
    if mesh.mesh_dim_names != (axis,):
        raise ValueError(f"expected a 1-D mesh over {axis!r}, got {mesh.mesh_dim_names}")


def batch_sharding(mesh, axis: str = DATA_AXIS):
    """Placements that split the leading batch axis across the mesh."""
    from torch.distributed.tensor import Shard

    _check_axis(mesh, axis)
    return [Shard(0)]


def replicated(mesh):
    """Placements that hold the whole value on every rank."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim
