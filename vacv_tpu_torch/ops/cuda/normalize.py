"""Per-plane self-statistics normalize: the normalize kernel's wrapper.

The counterpart of ``vacv_tpu/ops/pallas/normalize.py::
normalize_fused_pallas``.  ``normalize_fused`` takes P contiguous planes
(P, h, w) of u8 or f32 and returns ``(x−μ)/(σ+1e-6)`` as f32, each plane
with its own mean and population stddev.  On a CUDA tensor it launches
the hand-written kernel (``vacv_tpu_torch/csrc/normalize.cu``: one launch,
in the form ``launch_plan`` picks), counted as ``"normalize_fused"``, or
raises; on a CPU tensor it runs the plain
version ``ops/normalize.py::normalize_torch``, counted as
``"normalize_fused_torch"``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ... import config
from ...core.device_tables import stream_key
from ...core.image import Image
from ...core.types import Layout
from ..normalize import normalize_torch
from . import build

@dataclass(frozen=True)
class Limits:
    """What the launch plan needs of the card and the kernels
    (``vacv_normalize_limits``)."""
    sms: int
    smem_bytes: int        # shared bytes a grid-form block may hold
    blocks_per_sm: int     # grid-form blocks resident on an SM at that size
    cluster_threads: int
    cluster_items: int     # elements a cluster-form thread holds
    max_cluster: int
    grid_threads: int


@dataclass(frozen=True)
class Plan:
    """One launch: ``form`` "cluster" (``cluster`` blocks a plane, ``grid``
    = planes x cluster blocks in all, no scratch) or "grid" (``grid``
    co-resident blocks; each plane cut into ``per_plane`` slices of
    ``slice`` elements, one a block, which holds ``cap`` of them in
    ``smem_bytes`` of shared memory; ``rounds`` rounds of ``grid //
    per_plane`` planes; ``scratch`` doubles)."""
    form: str
    cluster: int
    grid: int
    threads: int
    per_plane: int
    slice: int
    cap: int
    rounds: int
    smem_bytes: int
    scratch: int
    stream: bool


FORMS = ("auto", "cluster", "grid")
_MIN_SLICE = 4096      # elements: below this a grid-form block has too little to do
# An f32 output above this is stored evict-first: it cannot stay in the
# card's L2 (50 MB on an H100) beside its input, and pushes the input out
# on its way to memory otherwise.
_STREAM_BYTES = 8 << 20


def launch_plan(planes: int, plane: int, itemsize: int, lim: Limits,
                form: str = "auto") -> Plan:
    """The grid, cluster and shared-memory sizes of one normalize launch:
    the one place they are decided.

    ``planes`` planes of ``plane`` elements of ``itemsize`` bytes, at any
    offset from a 16-byte boundary.  The cluster form serves planes that
    fit the registers of one cluster; everything larger takes the grid
    form."""
    if form not in FORMS:
        raise ValueError(f"normalize form must be one of {FORMS}, got {form!r}")
    if planes < 1 or plane < 1:
        raise ValueError(f"nothing to normalize: {planes} planes of {plane} elements")
    # Quads (four elements) that cover a plane, wherever its first element
    # falls in a quad.
    quads = -(-plane // 4) + 1
    per_block = lim.cluster_threads * (lim.cluster_items // 4)
    cluster = 1
    while cluster < lim.max_cluster and cluster * per_block < quads:
        cluster *= 2
    fits = cluster * per_block >= quads and planes * cluster < 2**31
    if form == "cluster" and not fits:
        raise ValueError(f"a plane of {plane} elements does not fit a cluster of {lim.max_cluster}")
    if form != "grid" and fits:
        return Plan("cluster", cluster, planes * cluster, lim.cluster_threads, 0, 0, 0, 0, 0, 0,
                    False)
    resident = lim.sms * lim.blocks_per_sm
    # A plane's slices start at the 16-byte boundary at or below its first
    # element: up to 15 elements more than the plane.
    span = plane + 15
    per_plane = max(1, min(resident // planes, -(-span // _MIN_SLICE)))
    per_round = min(planes, resident // per_plane)
    size = -(-(-(-span // per_plane)) // 16) * 16
    if size >= 2**31:
        raise ValueError(f"a plane of {plane} elements is too large for the normalize kernel")
    cap = min(size, lim.smem_bytes // itemsize // 16 * 16)
    return Plan("grid", 0, per_round * per_plane, lim.grid_threads, per_plane, size, cap,
                -(-planes // per_round), cap * itemsize, 4 * planes * per_plane,
                planes * plane * 4 > _STREAM_BYTES)


@functools.lru_cache(maxsize=None)
def _limits(device_index: int) -> Limits:
    return Limits(*build.limits("vacv_normalize_limits", device_index, 7))


@build.traced("normalize_fused")
def _launch(planes, form):
    if planes.ndim != 3:
        raise ValueError(f"normalize kernel needs (P, h, w) planes, got {tuple(planes.shape)}")
    if planes.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"normalize kernel takes uint8 or float32, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("normalize kernel needs contiguous planes")
    p, h, w = planes.shape
    dev = planes.device
    out = torch.empty((p, h, w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = launch_plan(p, h * w, planes.element_size(), _limits(dev.index), form)
    part = None
    if plan.scratch:
        part = torch.empty(plan.scratch, dtype=torch.float64, device=dev)
    args = (dev.index, stream_key(dev), planes.data_ptr(), int(planes.dtype == torch.uint8),
            out.data_ptr(), p, h * w, plan.cluster, plan.grid, plan.per_plane, plan.slice,
            plan.cap, plan.rounds, int(plan.stream), None if part is None else part.data_ptr())
    build.call(build.entry("vacv_normalize_planes"), args, f"normalize kernel ({plan.form} form)")
    config.record_kernel("normalize_fused")
    return out


def normalize_fused(planes: torch.Tensor, form: str = "auto") -> torch.Tensor:
    """Self-normalize each of the (P, h, w) planes; f32 out.

    ``form`` picks the kernel's launch form (``launch_plan``): "auto", or
    "cluster" / "grid" to hold one form to the other.  Raises ValueError
    for planes the kernel does not take (not rank 3, not u8 or f32, not
    contiguous, or too large for a requested cluster form)."""
    if form not in FORMS:
        raise ValueError(f"normalize form must be one of {FORMS}, got {form!r}")
    return build.dispatch("normalize_fused", planes, lambda: _launch(planes, form),
                          lambda: normalize_torch(Image(planes, Layout.CHW)).data)
