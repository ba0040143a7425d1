"""Preprocess pipelines — the package's "model" layer.

The counterpart of ``vacv_tpu/models/pipeline.py``.  ``Preprocessor``
holds a declarative ``PreprocessConfig`` and runs it on a frame or a
batch of frames.  Where the config is the reference's flagship chain
(crop → resize → CHW f32 → normalize, BASELINE config 4) the whole chain
is one fused call (``ops/cuda/preprocess.py``): over u8 BGR frames, or,
with an NV ``color_code`` and bilinear resize, over stacked NV21/NV12
camera buffers with the decode inside the kernel.  A config with a
``warp`` (BASELINE config 5) crops the batch, warps all its frames in
one call of the warp kernel's wrapper (``ops/cuda/warp_affine.py``; a crop
top on the device goes to the kernel with the uncut frames), then
runs the tail (resize → layout → f32 → normalize): on three u8 planes
with a linear, cubic or nearest resize to CHW, as one call of the fused
kernel over the whole warped batch (``preprocess_fused_planes``), else
frame by frame.  Each wrapper is the CUDA kernel for a CUDA tensor and
its plain PyTorch version for a CPU tensor.  Anything else runs the chain
of ops frame by frame; an NV chain decodes straight to CHW planes first,
any other colour code goes through ``cvt_color``.

Launch records: for a CUDA batch on the fused routes, and on the warp route
with a planar tail, ``batch`` keeps the wrappers' prepared launches
(``FusedLaunch``, ``WarpLaunch``) under the batch's ``launch_signature``
(at most ``_RECORDS`` of them, the oldest dropped first).  A later batch of
the same signature only runs them: no route choice, no geometry, no views,
no plan or table lookup.  The same kernels get the same arguments, so the
output is the same bits.  On the warp route the record takes one fused call
(``prepare_fused_warp``: the warp sampled only where the tail's resize reads
it, no warped intermediate, the same bits) wherever that call serves the
batch: a 3-channel u8 HWC batch whose tail takes the moments form; else the
warp's launch, then the planar tail's.

Devices: a tensor is processed on the device it lies on; a numpy input
goes to the ``device`` the Preprocessor was given, by default
``config.default_device()``: the card unless the caller asked for the CPU.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from ..core.device_tables import stream_key
from ..core.image import Image, as_tensor
from ..core.types import ColorCode, InterMode, Layout, VRect
from ..ops.crop import crop, crop_dynamic, dynamic_slice, static_start
from ..ops.cuda.preprocess import (
    INTERP_MODES, prepare_fused_batch, prepare_fused_nv_batch, prepare_fused_planes,
    prepare_fused_warp, preprocess_fused_batch, preprocess_fused_nv_batch,
    preprocess_fused_planes,
)
from ..ops.cuda.warp_affine import prepare_warp_planes, warp_planes_batch
from ..ops.cvt_color import cvt_color, nv_code, nv_decode_channels
from ..ops.dtype import as_torch_dtype
from ..ops.normalize import normalize
from ..ops.resize import resize
from ..ops.warp_affine import invert_affine, warp_affine
from ..utils import trace

_FUSED_INTERP = {mode: name for name, mode in INTERP_MODES.items()}
_RECORDS = 16  # launch records a Preprocessor keeps; the oldest goes first
_UNSEEN = object()


def launch_signature(arr, top) -> tuple:
    """What a CUDA batch's launch record is made from, beside the
    Preprocessor's own config: the backend preference, the batch's shape,
    strides, type and device, the handle of the device's current stream,
    and the kind of ``top``: None, an int (not its value) or a tensor's
    type, device and size (not its value)."""
    if top is None:
        kind = None
    elif isinstance(top, torch.Tensor):
        kind = (top.dtype, top.get_device(), top.numel())
    else:
        kind = int
    return (config.use_fused(), arr.shape, arr.stride(), arr.dtype, arr.get_device(),
            stream_key(arr.device), kind)


class _WarpRows:
    """Where a warp-route record reads a batch: from ``offset`` bytes into
    it, and for an int top, its clamped rows (at most ``row_hi``) of
    ``row_bytes`` each, as ``_crop_args`` narrows them."""

    __slots__ = ("offset", "row_bytes", "row_hi")

    def __init__(self, offset, row_bytes, row_hi):
        self.offset, self.row_bytes, self.row_hi = offset, row_bytes, row_hi

    def at(self, top):
        """(the top the launch takes, the source's byte offset) for ``top``."""
        if self.row_bytes:  # an int top: its rows narrowed here
            return None, self.offset + min(max(int(top), 0), self.row_hi) * self.row_bytes
        return top, self.offset


class _FusedWarpRecord(_WarpRows):
    """A warp-route batch prepared as one call, ``fused``, that samples the
    warp inside the tail's resize (``prepare_fused_warp``)."""

    __slots__ = ("fused",)

    def __init__(self, fused, *at):
        super().__init__(*at)
        self.fused = fused

    def run(self, arr, top):
        top, offset = self.at(top)
        return self.fused.run(arr, top, offset)


class _WarpRecord(_WarpRows):
    """A warp-route batch prepared as the warp's launch into the warped
    intermediate held here, then the planar tail's launch.  Holding the
    intermediate is safe as ``FusedLaunch`` holds its scratch: the warp
    kernel is an ordinary launch, so it writes the intermediate only after
    the previous call's tail on this stream has read it."""

    __slots__ = ("warp", "tail", "warped")

    def __init__(self, warp, tail, warped, *at):
        super().__init__(*at)
        self.warp, self.tail, self.warped = warp, tail, warped

    def run(self, arr, top):
        top, offset = self.at(top)
        return self.tail.run(self.warp.run(arr, top, self.warped, offset))


def _decode_color(img: Image, code) -> Image:
    """Pipeline-internal colour decode.  NV codes stay planar: the channel
    planes stack straight into a CHW Image, so no HWC interleave is made
    only to be transposed back.  Any other code is ``cvt_color``'s."""
    if nv_code(code) is None:
        return cvt_color(img, code)
    return Image(torch.stack(nv_decode_channels(img.data, code), dim=0), Layout.CHW)


@dataclass(frozen=True)
class PreprocessConfig:
    """Declarative preprocessing recipe (all fields static)."""

    # Colour conversion applied first (any ``cvt_color`` code); for an NV
    # code the input is the stacked (H*3//2, W) NV buffer.
    color_code: ColorCode | None = None
    # Optional crop ROI in source coordinates.
    crop_rect: VRect | None = None
    # Optional affine warp: (2x3 forward matrix as a nested tuple, (w, h)
    # output size).  Applied after the crop, before the resize (BASELINE
    # config 5): INTER_LINEAR, BORDER_CONSTANT, border value 0.
    warp: tuple[tuple, tuple[int, int]] | None = None
    # Output spatial size (w, h); None keeps input size.
    out_size: tuple[int, int] | None = None
    interpolation: InterMode = InterMode.INTER_LINEAR
    # Output layout & normalization.
    out_layout: Layout = Layout.CHW
    normalize: bool = True
    mean: tuple[float, ...] | None = None
    stddev: tuple[float, ...] | None = None


class Preprocessor:
    """Runs a ``PreprocessConfig`` on HWC u8 frames, or on stacked
    (H·3/2, W) u8 NV buffers when ``color_code`` is an NV code.

    ``__call__`` takes one frame, ``batch`` a batch of them; both return
    the network-ready float32 tensor.
    """

    def __init__(self, cfg: PreprocessConfig, device=None):
        if cfg.color_code is not None:
            ColorCode(cfg.color_code)  # ValueError for an unknown code
        self.cfg = cfg
        self.device = torch.device(device if device is not None else config.default_device())
        self._records: dict = {}  # launch_signature -> record, None for a route with none

    def _fused_geometry(self, shape, dtype):
        """(nv, left, top, cw, ch, oh, ow, interp) when the whole
        pipeline runs as ONE fused call for frames of per-image
        ``shape`` (HWC, or (H·3/2, W) for NV input), else None.  ``nv``
        is None for BGR input, else an (is_nv12, to_rgb) pair.

        Any crop that lies inside the frame is taken; there are no
        alignment or size floors.
        """
        cfg = self.cfg
        if not config.use_fused() or cfg.warp is not None:
            return None
        interp = _FUSED_INTERP.get(InterMode(cfg.interpolation))
        if cfg.out_size is None or interp is None or cfg.out_layout != Layout.CHW:
            return None
        if as_torch_dtype(dtype) != torch.uint8:
            return None
        nv = None
        if cfg.color_code is not None:
            # The fused NV kernel is linear only and makes no alpha plane;
            # other codes take the chain (vacv_tpu/models/pipeline.py:167-176).
            flags = nv_code(cfg.color_code)
            if flags is None:
                return None
            is_nv12, to_rgb, alpha = flags
            if alpha or interp != "linear":
                return None
            nv = (is_nv12, to_rgb)
            if len(shape) != 2 or shape[0] % 3 or shape[1] % 2:
                return None
            h, w = shape[0] * 2 // 3, shape[1]
        else:
            if len(shape) != 3 or shape[-1] != 3:
                return None
            h, w, _ = shape
        if cfg.crop_rect is None:
            left, top, cw, ch = 0, 0, w, h
        else:
            left, top, cw, ch = cfg.crop_rect.int_bounds()
        if left < 0 or top < 0 or cw <= 0 or ch <= 0 or left + cw > w or top + ch > h:
            return None
        ow, oh = int(cfg.out_size[0]), int(cfg.out_size[1])
        if ow <= 0 or oh <= 0:
            return None
        return (nv, left, top, cw, ch, oh, ow, interp)

    def _warp_route(self) -> bool:
        """Does a batch take the warp route (one warp call over the whole
        batch, then the tail)?  Any warp config does, under the ``auto``
        backend, whatever its input shape, type or interpolation."""
        return self.cfg.warp is not None and config.use_fused()

    def describe_route(self, shape, dtype=None, device=None) -> str:
        """Which route a batch of per-image ``shape`` frames (HWC, or
        (H·3/2, W) for NV input) takes: ``"cuda_fused"`` /
        ``"cuda_fused_nv"`` / ``"cuda_warp"`` (the CUDA kernel),
        ``"fused_torch"`` / ``"fused_nv_torch"`` / ``"warp_torch"`` (its
        plain PyTorch version, on a CPU tensor) or ``"torch_chain"``.

        ``device`` is where the batch lies; None means the
        Preprocessor's own device (where a numpy batch goes)."""
        dev = torch.device(device) if device is not None else self.device
        if self._warp_route():
            return "cuda_warp" if dev.type == "cuda" else "warp_torch"
        geom = self._fused_geometry(tuple(shape), dtype or torch.uint8)
        if geom is None:
            return "torch_chain"
        nv = "_nv" if geom[0] is not None else ""
        return f"cuda_fused{nv}" if dev.type == "cuda" else f"fused{nv}_torch"

    def _fused_call(self, geom, top):
        """(nv, args, kwargs) of the fused wrapper's call for ``geom``
        (``_fused_geometry``); ``nv`` picks the NV wrapper."""
        cfg = self.cfg
        nv, left, top0, cw, ch, oh, ow, interp = geom
        kwargs = dict(top=top, mean=cfg.mean, stddev=cfg.stddev, normalize=cfg.normalize)
        if nv is None:
            kwargs["interp"] = interp
        else:
            # Camera chain: decode → crop → resize → normalize in one call.
            kwargs["is_nv12"], kwargs["to_rgb"] = nv
        return nv is not None, (VRect(left, top0, left + cw, top0 + ch), (ow, oh)), kwargs

    def _run_fused(self, batch, geom, top):
        nv, args, kwargs = self._fused_call(geom, top)
        return (preprocess_fused_nv_batch if nv else preprocess_fused_batch)(batch, *args, **kwargs)

    def _crop_args(self, top):
        """(left, top, cw, ch, static) of the crop, or None for no crop:
        the rect's own top when ``top`` is None (``static``), else the
        runtime ``top``: an int clamped below at 0, as the fused route
        clamps it, a tensor as given (its users clamp it)."""
        if self.cfg.crop_rect is None:
            return None
        left, top0, cw, ch = self.cfg.crop_rect.int_bounds()
        if cw <= 0 or ch <= 0:
            raise ValueError(f"empty crop rect {self.cfg.crop_rect}")
        if top is None:
            return left, top0, cw, ch, True
        if not isinstance(top, torch.Tensor):
            top = max(int(top), 0)
        return left, top, cw, ch, False

    def _tail(self, img: Image):
        """The stages after the crop and the warp (resize → layout → f32 →
        normalize) on one image: shared by the chain and the warp route,
        so the two stay identical past the warp (the reference's
        ``_tail_fn``)."""
        cfg = self.cfg
        if cfg.out_size is not None:
            w, h = cfg.out_size
            img = resize(img, (w, h), interpolation=cfg.interpolation)
        img = img.change_layout(cfg.out_layout)
        img = img.change_dtype(torch.float32)
        if cfg.normalize:
            img = normalize(img, cfg.mean, cfg.stddev)
        return img.data

    def _run_chain(self, frame, top):
        """The per-image chain of ops ([NV decode →] crop → [warp →]
        resize → layout → f32 → normalize)."""
        cfg = self.cfg
        img = Image(frame, Layout.HWC)
        if cfg.color_code is not None:
            img = _decode_color(img, cfg.color_code)
        args = self._crop_args(top)
        if args is not None:
            left, top, cw, ch, static = args
            if static:
                img = crop(img, cfg.crop_rect)
            else:
                if isinstance(top, torch.Tensor):
                    top = torch.clamp(top, min=0)
                img = crop_dynamic(img, left, top, cw, ch)
        if cfg.warp is not None:
            m, dsize = cfg.warp
            img = warp_affine(img.change_layout(Layout.CHW), [list(r) for r in m], tuple(dsize))
        return self._tail(img)

    def _planar_tail(self, dtype, channels) -> str | None:
        """The fused kernel's interpolation name when the tail of a warped
        (N, ``channels``, h, w) batch of ``dtype`` runs as one
        ``preprocess_fused_planes`` call: three u8 planes, an output size,
        CHW output and a linear, cubic or nearest resize.  None keeps the
        per-frame ``_tail``."""
        cfg = self.cfg
        if dtype != torch.uint8 or channels != 3:
            return None
        if cfg.out_size is None or cfg.out_layout != Layout.CHW:
            return None
        return _FUSED_INTERP.get(InterMode(cfg.interpolation))

    @functools.cached_property
    def _minv(self):
        """The inverse of the config's warp matrix."""
        m, _ = self.cfg.warp
        return invert_affine(np.asarray([list(r) for r in m], dtype=np.float32))

    def _warp_source(self, batch, top):
        """(planes, row0, rows, gray) of the warp route: [NV decode →] the
        batch's (N, C, H, W) planes, cropped; a tensor ``top`` leaves the
        rows uncut and goes to the warp as its ``row0`` of ``rows`` rows:
        the kernel reads the crop at that top and clamps it, so no gather
        copies the crop."""
        cfg = self.cfg
        if cfg.color_code is not None:
            planes = torch.stack([_decode_color(Image(f, Layout.HWC), cfg.color_code)
                                  .change_layout(Layout.CHW).data for f in batch])
            gray = planes.ndim == 3  # e.g. BGR2GRAY
        else:
            gray = batch.ndim == 3
            planes = batch if gray else batch.permute(0, 3, 1, 2)  # read through its strides
        if gray:
            planes = planes[:, None]
        args = self._crop_args(top)
        row0 = rows = None
        if args is not None:
            left, top, cw, ch, static = args
            if static:
                planes = planes[:, :, top : top + ch, left : left + cw]
            elif isinstance(top, torch.Tensor):
                planes = planes.narrow(3, static_start(left, planes.shape[3], cw), cw)
                row0, rows = top, ch
            else:
                planes = dynamic_slice(dynamic_slice(planes, 2, top, ch), 3, left, cw)
        return planes, row0, rows, gray

    def _run_warp(self, batch, top):
        """BASELINE config 5: [NV decode →] crop the batch, warp all N·C
        planes in one call (INTER_LINEAR, BORDER_CONSTANT, border value 0,
        as the reference's ``warp_affine(img, m, dsize)``), then the tail:
        one fused call over the warped batch (``_planar_tail``), else the
        per-frame ``_tail``."""
        cfg = self.cfg
        planes, row0, rows, gray = self._warp_source(batch, top)
        _, (w, h) = cfg.warp
        out = warp_planes_batch(planes, self._minv, int(h), int(w), row0=row0, rows=rows)
        interp = self._planar_tail(out.dtype, out.shape[1])
        if interp is not None:
            return preprocess_fused_planes(out, cfg.out_size, interp=interp, mean=cfg.mean,
                                           stddev=cfg.stddev, normalize=cfg.normalize)
        return torch.stack([self._tail(Image(o[0] if gray else o, Layout.CHW)) for o in out])

    def _prepare(self, arr, top):
        """The launch record of CUDA batches like ``arr`` with tops like
        ``top``: the fused route's ``FusedLaunch``; on the warp route, when
        the batch is (N, H, W, 3) u8 with no colour code (its tail then
        takes the planar call), a ``_FusedWarpRecord`` where
        ``prepare_fused_warp`` serves it, else a ``_WarpRecord``; None for
        any other route."""
        if not self._warp_route():
            geom = self._fused_geometry(tuple(arr.shape[1:]), arr.dtype)
            if geom is None:
                return None
            nv, args, kwargs = self._fused_call(geom, top)
            return (prepare_fused_nv_batch if nv else prepare_fused_batch)(arr, *args, **kwargs)
        cfg = self.cfg
        interp = self._planar_tail(arr.dtype, arr.shape[-1])
        if cfg.color_code is not None or arr.ndim != 4 or interp is None:
            return None
        int_top = top is not None and not isinstance(top, torch.Tensor)
        planes, row0, rows, _ = self._warp_source(arr, 0 if int_top else top)
        _, (w, h) = cfg.warp
        at = (planes.data_ptr() - arr.data_ptr(),
              planes.stride(2) * planes.element_size() if int_top else 0,
              arr.shape[1] - planes.shape[2])
        kw = dict(interp=interp, mean=cfg.mean, stddev=cfg.stddev, normalize=cfg.normalize)
        fused = prepare_fused_warp(planes, self._minv, int(h), int(w), cfg.out_size, row0=row0,
                                   rows=rows, **kw)
        if fused is not None:
            return _FusedWarpRecord(fused, *at)
        warp = prepare_warp_planes(planes, self._minv, int(h), int(w), row0=row0, rows=rows)
        warped = torch.empty(warp.shape, dtype=torch.uint8, device=arr.device)
        return _WarpRecord(warp, prepare_fused_planes(warped, cfg.out_size, **kw), warped, *at)

    def _record(self, arr, top):
        """The launch record of CUDA batch ``arr`` with ``top`` (``_prepare``),
        made on the first batch of its ``launch_signature`` and counted as
        ``pipeline.records_made``; each later batch of the signature is a
        hit, counted as ``pipeline.record_hits``.  None where the batch's
        route has no record."""
        key = launch_signature(arr, top)
        rec = self._records.get(key, _UNSEEN)
        if rec is _UNSEEN:
            rec = self._prepare(arr, top)
            if len(self._records) >= _RECORDS:
                del self._records[next(iter(self._records))]
            self._records[key] = rec
            if rec is not None:
                trace.count("pipeline.records_made")
        elif rec is not None:
            trace.count("pipeline.record_hits")
        return rec

    def batch(self, arr, top=None):
        """Run the pipeline over (N, H, W, C) frames, or (N, H·3/2, W) NV
        buffers.

        ``top`` optionally moves the crop rect's top at run time (a
        Python int or a 0-d integer tensor, e.g. from a tracker running
        on the device); the crop keeps its size and is clamped to the
        frame.

        A CUDA batch runs its launch record (module docstring), made on the
        first batch of its signature: counters ``pipeline.records_made`` and
        ``pipeline.record_hits``.  Traced as span ``pipeline.batch``
        (``utils/trace.py``)."""
        span = trace.begin("pipeline.batch") if trace.ON else None
        try:
            arr = as_tensor(arr, self.device)
            if arr.is_cuda:
                rec = self._record(arr, top)
                if rec is not None:
                    return rec.run(arr, top)
            if self._warp_route():
                return self._run_warp(arr, top)
            geom = self._fused_geometry(tuple(arr.shape[1:]), arr.dtype)
            if geom is not None:
                return self._run_fused(arr, geom, top)
            return torch.stack([self._run_chain(frame, top) for frame in arr])
        finally:
            if span is not None:
                trace.end(span)

    def __call__(self, arr):
        """Run the pipeline on one (H, W, C) frame or (H·3/2, W) NV buffer."""
        return self.batch(as_tensor(arr, self.device)[None])[0]

    def fn(self, frame):
        """The per-image chain of ops on one frame (the JAX package's
        ``fn``, the function its ``vmap``/``shard_map`` lift): no fused
        route, whatever the config."""
        return self._run_chain(as_tensor(frame, self.device), None)

    @functools.cached_property
    def batch_fn(self):
        """The (N, ...) batch function: ``batch``, which takes the fused,
        warp or chain route per call from the batch's shape and device."""
        return self.batch

    def batched(self, mesh=None):
        """Sharded batch function: (N, ...) frames with N split over the
        mesh's data axis (a global batch, or a ``put_sharded`` DTensor).
        Each rank runs ``batch`` on its local shard, on its own device
        (not ``self.device``), so it launches the fused kernel once on its
        shard where the plan allows.  Returns a DTensor sharded on the
        batch axis."""
        from ..parallel.mesh import make_mesh
        from ..parallel.pipeline import as_sharded, local_shard

        if mesh is None:
            mesh = make_mesh()

        def run(arr, top=None):
            return as_sharded(self.batch(local_shard(arr, mesh), top=top), mesh)

        return run


def slam_frontend_config() -> PreprocessConfig:
    """BASELINE config 4's flagship chain for a SLAM/SfM keyframe front
    end: resize to 224×224 → CHW → f32 → normalize.  Add a ``crop_rect``
    with ``dataclasses.replace`` when the camera ROI is known."""
    return PreprocessConfig(
        out_size=(224, 224),
        interpolation=InterMode.INTER_LINEAR,
        out_layout=Layout.CHW,
        normalize=True,
    )
