"""Preprocess pipelines — the package's "model" layer.

The counterpart of ``vacv_tpu/models/pipeline.py``.  ``Preprocessor``
holds a declarative ``PreprocessConfig`` and runs it on a frame or a
batch of frames.  Where the config is the reference's flagship chain
(crop → resize → CHW f32 → normalize, BASELINE config 4) the whole chain
is one fused call (``ops/cuda/preprocess.py``): over u8 BGR frames, or,
with an NV ``color_code`` and bilinear resize, over stacked NV21/NV12
camera buffers with the decode inside the kernel.  A config with a
``warp`` (BASELINE config 5) crops the batch, warps all its frames in
one call of the warp kernel's wrapper (``ops/cuda/warp_affine.py``) and
runs the per-frame tail (resize → layout → f32 → normalize).  Each
wrapper is the CUDA kernel for a CUDA tensor and its plain PyTorch
version for a CPU tensor.  Anything else runs the chain of ops frame by
frame; an NV chain decodes straight to CHW planes first, any other
colour code goes through ``cvt_color``.

Devices: a tensor is processed on the device it lies on; a numpy input
goes to the ``device`` the Preprocessor was given, by default
``config.default_device()``: the card unless the caller asked for the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from ..core.image import Image, as_tensor
from ..core.types import ColorCode, InterMode, Layout, VRect
from ..ops.crop import crop, crop_dynamic, dynamic_slice
from ..ops.cuda.preprocess import (
    INTERP_MODES, preprocess_fused_batch, preprocess_fused_nv_batch,
)
from ..ops.cuda.warp_affine import warp_planes_batch
from ..ops.cvt_color import cvt_color, nv_code, nv_decode_channels
from ..ops.dtype import as_torch_dtype
from ..ops.normalize import normalize
from ..ops.resize import resize
from ..ops.warp_affine import invert_affine, warp_affine

_FUSED_INTERP = {mode: name for name, mode in INTERP_MODES.items()}


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
        batch, then the per-frame tail)?  Any warp config does, under the
        ``auto`` backend, whatever its input shape, type or
        interpolation."""
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

    def _run_fused(self, batch, geom, top):
        cfg = self.cfg
        nv, left, top0, cw, ch, oh, ow, interp = geom
        rect = VRect(left, top0, left + cw, top0 + ch)
        kwargs = dict(top=top, mean=cfg.mean, stddev=cfg.stddev, normalize=cfg.normalize)
        if nv is not None:
            # Camera chain: decode → crop → resize → normalize in one call.
            is_nv12, to_rgb = nv
            return preprocess_fused_nv_batch(batch, rect, (ow, oh), is_nv12=is_nv12,
                                             to_rgb=to_rgb, **kwargs)
        return preprocess_fused_batch(batch, rect, (ow, oh), interp=interp, **kwargs)

    def _crop_args(self, top):
        """(left, top, cw, ch, static) of the crop, or None for no crop:
        the rect's own top when ``top`` is None (``static``), else the
        runtime ``top`` clamped below at 0, as the fused route clamps it."""
        if self.cfg.crop_rect is None:
            return None
        left, top0, cw, ch = self.cfg.crop_rect.int_bounds()
        if cw <= 0 or ch <= 0:
            raise ValueError(f"empty crop rect {self.cfg.crop_rect}")
        if top is None:
            return left, top0, cw, ch, True
        top = torch.clamp(top, min=0) if isinstance(top, torch.Tensor) else max(int(top), 0)
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
            img = crop(img, cfg.crop_rect) if args[-1] else crop_dynamic(img, *args[:-1])
        if cfg.warp is not None:
            m, dsize = cfg.warp
            img = warp_affine(img.change_layout(Layout.CHW), [list(r) for r in m], tuple(dsize))
        return self._tail(img)

    def _run_warp(self, batch, top):
        """BASELINE config 5: [NV decode →] crop the batch, warp all N·C
        planes in one call (INTER_LINEAR, BORDER_CONSTANT, border value 0,
        as the reference's ``warp_affine(img, m, dsize)``), then the
        per-frame tail."""
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
        if args is not None:
            left, top, cw, ch, static = args
            if static:
                planes = planes[:, :, top : top + ch, left : left + cw]
            else:
                planes = dynamic_slice(dynamic_slice(planes, 2, top, ch), 3, left, cw)
        m, (w, h) = cfg.warp
        minv = invert_affine(np.asarray([list(r) for r in m], dtype=np.float32))
        out = warp_planes_batch(planes, minv, int(h), int(w))
        return torch.stack([self._tail(Image(o[0] if gray else o, Layout.CHW)) for o in out])

    def batch(self, arr, top=None):
        """Run the pipeline over (N, H, W, C) frames, or (N, H·3/2, W) NV
        buffers.

        ``top`` optionally moves the crop rect's top at run time (a
        Python int or a 0-d integer tensor, e.g. from a tracker running
        on the device); the crop keeps its size and is clamped to the
        frame."""
        arr = as_tensor(arr, self.device)
        if self._warp_route():
            return self._run_warp(arr, top)
        geom = self._fused_geometry(tuple(arr.shape[1:]), arr.dtype)
        if geom is not None:
            return self._run_fused(arr, geom, top)
        return torch.stack([self._run_chain(frame, top) for frame in arr])

    def __call__(self, arr):
        """Run the pipeline on one (H, W, C) frame or (H·3/2, W) NV buffer."""
        return self.batch(as_tensor(arr, self.device)[None])[0]
