"""Fused [NV decode →] crop → resize → u8 truncation → planar f32 →
normalize, batched.

The counterpart of ``vacv_tpu/ops/pallas/preprocess.py``'s two entry
points:

* ``preprocess_fused_batch`` (BASELINE config 4, the main path): given a
  (N, H, W, 3) u8 BGR batch, a crop ``(left, top, cw, ch)`` and an output
  size, it returns (N, 3, oh, ow) f32: each crop resized separably
  (vertical taps, then horizontal), truncated to the u8 grid, and
  normalized per (frame, channel) as ``(x−μ)/(σ+1e-6)`` with self or
  static statistics.
* ``preprocess_fused_nv_batch`` (the camera path): the same chain, linear
  only, over a (N, H·3/2, W) u8 stacked NV21/NV12 batch, with the Q7
  decode (``ops/cvt_color.py``) done per tap inside the kernel.

``preprocess_fused_planes`` runs the same kernel's resize → truncation →
normalize on (N, 3, h, w) u8 planes, the affine warp's output: BASELINE
config 5's tail for the whole warped batch in one call (the reference
runs that tail per frame under ``jax.vmap``, ``vacv_tpu/models/
pipeline.py::_run_warp_fold``).  ``prepare_fused_warp`` takes config 5's
warp and that tail as one call (``csrc/preprocess_warp.cu``): the moments
form's source is the warp itself, each warped pixel computed where the
resize reads it, with the warp kernel's arithmetic, so the output is the
two calls' bit for bit with no warped planes in between;
``models/pipeline.py`` takes it wherever it serves a batch.

Each wrapper launches the hand-written kernel
(``vacv_tpu_torch/csrc/preprocess.cu``) on a CUDA tensor or raises; on a
CPU tensor it runs the plain PyTorch version beside it
(``preprocess_fused_batch_torch`` / ``preprocess_fused_nv_batch_torch`` /
``preprocess_fused_planes_torch``), which the CPU tests and
``chip_smoke.py`` hold the kernel against.  On the card each wrapper is two
parts: ``prepare_fused_batch`` / ``prepare_fused_nv_batch`` /
``prepare_fused_planes`` do the checks, the geometry, the plan, the tap
tables and the argument packing and return a ``FusedLaunch``, whose ``run``
makes the call; ``models/pipeline.py`` keeps such records for the batches it
sees again.

The kernel reads resize weights as tap tables: for every output row
(column) a start index and K weights, K = 2 (linear), 4 (cubic) or
1 (nearest).  ``tap_table`` builds them from the same dense matrices the
plain versions multiply by, and checks that they reconstruct them
exactly.

A call runs in one of four forms, which ``launch_plan`` picks:
``"moments"`` (BGR or planar, truncated output with a self-computed
statistic, the config-4 main path and the config-5 tail: the resize launch
stores the truncated planes as u8 with each block's exact integer moments,
then a second launch scales them into the f32 output, which is written
once and never read back),
``"one_pass"`` (NV, the same output in one cooperative launch: a frame's
blocks keep its truncated planes on the SM as u8 and meet at one
barrier), ``"two_launch"`` (the f32 resize launch, then the
normalize launch: self statistics without truncation, or frames too
large for the other forms) and ``"resize_only"`` (static statistics or
``normalize=False``: one launch).  ``one_pass_stats`` is the host twin of
the integer-moment statistics.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...core.device_tables import stream_cached, stream_key
from ...core.types import BorderMode, InterMode
from ..crop import dynamic_slice
from ..cvt_color import yuv_to_bgr_q7
from ..normalize import normalize_planes
from ..resize import (
    _cubic_weights, _linear_weights, _nearest_weights, u8_epilogue, u8_eps,
)
from . import build
from .warp_affine import _check as _check_warp, hwc3_form

# The interpolations the kernel takes, and its taps per output row/column.
INTERP_MODES = {
    "linear": InterMode.INTER_LINEAR,
    "cubic": InterMode.INTER_CUBIC,
    "nearest": InterMode.INTER_NEAREST,
}
_TAPS = {"linear": 2, "cubic": 4, "nearest": 1}
_MAX_FRAMES = 65535  # the kernels' grid z (one-pass: y) dimension


@dataclass(frozen=True)
class CardLimits:
    """What the launch plan needs of the card and the one-pass kernel
    (``vacv_preprocess_limits``)."""
    sms: int
    threads_per_sm: int
    smem_bytes: int     # dynamic shared bytes a one-pass block may hold
    smem_per_sm: int    # shared bytes an SM holds


@dataclass(frozen=True)
class Plan:
    """One call: ``form`` "one_pass" (``blocks`` blocks a frame of 256
    threads in one cooperative launch, each owning ``rows`` output rows of
    all three channels in 3 x ``chan`` bytes of shared memory, the output
    stored evict-first when ``stream``), "moments" (the resize launch, then
    ``blocks`` blocks a plane of the scale launch), "two_launch" or
    "resize_only" (the other fields 0)."""
    form: str
    blocks: int = 0
    rows: int = 0
    chan: int = 0
    stream: bool = False


FORMS = ("auto", "one_pass", "two_launch")  # what an NV caller may hold a call to
SOURCES = ("bgr", "nv", "planar")
_GRID_BLOCKS = (1, 2, 4, 8, 16, 32, 64)  # the blocks a frame the plan considers
_ONE_PASS_THREADS = 256
# An f32 output above this is stored evict-first: it cannot stay in the
# card's L2 (50 MB on an H100) beside its source (as ops/cuda/normalize.py).
_STREAM_BYTES = 8 << 20
# Shared bytes the card keeps for each resident block beside its own.
_SMEM_RESERVE = 1024
_STATIC_SMEM = 128  # the one-pass kernel's own shared arrays
_MAX_BLOCKS_PER_SM = 32  # sm_90
# A one-pass thread's share of its strip, in pixels: a warp's sum of x^2
# must fit 32 bits (32 x 2064 x 255^2 < 2^32).
_MAX_PIXELS_A_THREAD = 2064
# The plan gives a one-pass thread at least this many output pixels where
# blocks share SMs: a block's fixed work (its moments, the barrier, the
# statistics) then stays small beside its taps.
_MIN_PIXELS_A_THREAD = 4
# A frame's pixels in the integer-moment forms: N sum x^2 - (sum x)^2 must
# fit 64 bits.
_MAX_ONE_PASS_PIXELS = 2**32 // 255 - 1
_SCALE_THREADS = 256  # the moments form's scale launch


def _scale_blocks(n: int, oh: int, ow: int, lim: CardLimits) -> int:
    """Blocks a plane of the moments form's scale launch: one wave of the
    card's threads over the 3n planes, and no block without a float4."""
    per_plane = max(1, lim.sms * lim.threads_per_sm // _SCALE_THREADS // (3 * n))
    return min(per_plane, -(-oh * ow // (4 * _SCALE_THREADS)))


def _strip_bytes(rows: int, ow: int) -> int:
    """Shared bytes of one channel's strip: its values, three more for the
    output's misalignment, rounded up to 16."""
    return -(-(rows * ow + 3) // 16) * 16


def one_pass_plan(n: int, oh: int, ow: int, lim: CardLimits, blocks: int) -> Plan | None:
    """The one-pass form of a call over ``n`` frames to (oh, ow) with
    ``blocks`` blocks a frame, or None where the card cannot run it: a
    cooperative launch needs every block resident at once, counted from
    threads, shared memory and the card's 32 blocks an SM (the kernel's
    launch bounds keep registers out of it)."""
    rows = -(-oh // blocks)
    chan = _strip_bytes(rows, ow)
    per_sm = min(lim.threads_per_sm // _ONE_PASS_THREADS, _MAX_BLOCKS_PER_SM,
                 lim.smem_per_sm // (3 * chan + _STATIC_SMEM + _SMEM_RESERVE))
    if not (blocks <= oh and 3 * chan <= lim.smem_bytes and n * blocks <= lim.sms * per_sm
            and -(-rows * ow // _ONE_PASS_THREADS) <= _MAX_PIXELS_A_THREAD
            and oh * ow <= _MAX_ONE_PASS_PIXELS and n <= _MAX_FRAMES):
        return None
    return Plan("one_pass", blocks, rows, chan, n * 3 * oh * ow * 4 > _STREAM_BYTES)


@functools.lru_cache(maxsize=256)  # 20 us of Python a call otherwise, on a host-bound path
def launch_plan(n: int, oh: int, ow: int, lim: CardLimits, *, source: str = "nv",
                normalize: bool = True, self_stats: bool = True, trunc_u8: bool = True,
                form: str = "auto") -> Plan:
    """The form and blocks of one call over ``n`` frames of ``source``
    ("bgr", "nv" or "planar") to (oh, ow): the one place they are decided.

    Truncated output with a self-computed statistic takes the moments form
    on a BGR or planar call, and on an NV call the one-pass form when every
    block fits the card at once (``one_pass_plan``); both need a frame under
    2^32 / 255 pixels.  A one-pass frame takes the most blocks that keep
    the n·C blocks at or under half of the card's threads and, where they
    outnumber the SMs, give each thread at least four output pixels; the
    fewest the card runs where no count does both.  On an H100 this count
    was the fastest NV form at 1, 8, 32 and 128 frames of 224², and the
    moments form the fastest BGR one at 1 and 32 frames and at every cubic
    batch (PERF.md).
    ``form`` "one_pass" or "two_launch" holds an NV call with self
    statistics to that form (ValueError where it cannot serve the call)."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if source not in SOURCES:
        raise ValueError(f"source must be one of {SOURCES}, got {source!r}")
    if not (normalize and self_stats):
        if form != "auto":
            raise ValueError(f"the {form} form needs a self-computed statistic")
        return Plan("resize_only")
    if form == "two_launch":
        return Plan("two_launch")
    exact = trunc_u8 and oh * ow <= _MAX_ONE_PASS_PIXELS
    if source != "nv" and form == "auto":
        if exact and 3 * n <= _MAX_FRAMES:
            return Plan("moments", _scale_blocks(n, oh, ow, lim))
        return Plan("two_launch")
    ok = [p for c in _GRID_BLOCKS
          if source == "nv" and exact and (p := one_pass_plan(n, oh, ow, lim, c))]
    if not ok:
        if form == "one_pass":
            raise ValueError(f"the one-pass form does not serve this call ({n} {source} frames "
                             f"to {oh}x{ow}, trunc_u8={trunc_u8})")
        return Plan("two_launch")
    good = [p for p in ok if 2 * n * p.blocks * _ONE_PASS_THREADS <= lim.sms * lim.threads_per_sm
            and (n * p.blocks <= lim.sms or p.rows * ow >= _MIN_PIXELS_A_THREAD * _ONE_PASS_THREADS)]
    return good[-1] if good else ok[0]


def _resize_weights(n_in: int, n_out: int, interp: str) -> np.ndarray:
    """Dense (n_out, n_in) resize weights, as the JAX kernel builds them
    (vacv_tpu/ops/pallas/preprocess.py:62-75): the Q11-quantized grid
    for linear, unquantized A=-0.75 cubic with boundary folding, one-hot
    nearest."""
    if interp == "cubic":
        return _cubic_weights(n_in, n_out)
    if interp == "nearest":
        return _nearest_weights(n_in, n_out)
    return _linear_weights(n_in, n_out, quantize=True)


def dense_from_taps(starts: np.ndarray, weights: np.ndarray, n_in: int) -> np.ndarray:
    """The dense (n_out, n_in) matrix a tap table stands for."""
    n_out, k = weights.shape
    dense = np.zeros((n_out, n_in), np.float32)
    cols = starts[:, None].astype(np.int64) + np.arange(k)
    np.put_along_axis(dense, cols, weights, axis=1)
    return dense


@functools.lru_cache(maxsize=64)
def tap_table(n_in: int, n_out: int, interp: str):
    """(starts int32 (n_out,), weights float32 (n_out, K)) for the
    kernel: output i reads inputs ``starts[i] .. starts[i] + K - 1``."""
    dense = _resize_weights(n_in, n_out, interp)
    # _cubic_weights degrades to linear below 4 inputs; a 1-input axis
    # has a single column.
    k = min(2 if interp == "cubic" and n_in < 4 else _TAPS[interp], n_in)
    nz = dense != 0
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    starts = np.minimum(first, n_in - k)
    cols = starts[:, None] + np.arange(k)
    weights = np.take_along_axis(dense, cols, axis=1).astype(np.float32)
    starts = starts.astype(np.int32)
    if not np.array_equal(dense_from_taps(starts, weights, n_in), dense):
        raise RuntimeError(
            f"resize weights ({interp}, {n_in}->{n_out}) have a nonzero "
            f"outside their {k}-tap window"
        )
    return starts, weights


@stream_cached(maxsize=64)
def _device_taps(n_in: int, n_out: int, interp: str, device: torch.device):
    """``tap_table`` on ``device``, copied there once for each CUDA stream
    (``core/device_tables.py``)."""
    starts, weights = tap_table(n_in, n_out, interp)
    return torch.from_numpy(starts).to(device), torch.from_numpy(weights).to(device)


def _static_stats(v):
    """Caller stats as a 3-tuple of floats (a scalar broadcasts), or None."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    arr = np.asarray(v, np.float32).reshape(-1)
    if arr.size == 1:
        arr = np.repeat(arr, 3)
    return tuple(float(x) for x in arr[:3])


def _crop_geometry(h, w, crop_rect, out_size, top):
    """(left, top, cw, ch, oh, ow) of a crop inside an h×w frame, or
    ValueError."""
    if isinstance(top, torch.Tensor) and (
        top.numel() != 1 or top.is_floating_point() or top.is_complex()
    ):
        raise ValueError("runtime top must be a 1-element integer tensor")
    if crop_rect is None:
        left, top0, cw, ch = 0, 0, w, h
    else:
        left, top0, cw, ch = crop_rect.int_bounds()
    ow, oh = int(out_size[0]), int(out_size[1])
    if left < 0 or cw <= 0 or ch <= 0 or left + cw > w or ch > h:
        raise ValueError("crop rect outside the frame")
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty output size {out_size}")
    return left, top0, cw, ch, oh, ow


def _geometry(batch, crop_rect, out_size, interp, top):
    """(n, h, w, left, top, cw, ch, oh, ow) of a BGR batch, or ValueError."""
    if batch.dtype != torch.uint8 or batch.ndim != 4 or batch.shape[-1] != 3:
        raise ValueError("fused preprocess needs (N, H, W, 3) uint8")
    if interp not in INTERP_MODES:
        raise ValueError(f"interp must be one of {tuple(INTERP_MODES)}, got {interp!r}")
    n, h, w, _ = batch.shape
    return (n, h, w) + _crop_geometry(h, w, crop_rect, out_size, top)


def _planes_geometry(planes, out_size, interp):
    """(n, h, w, left, top, cw, ch, oh, ow) of (N, 3, h, w) u8 planes, read
    whole (no crop), or ValueError."""
    if planes.dtype != torch.uint8 or planes.ndim != 4 or planes.shape[1] != 3:
        raise ValueError("fused planar preprocess needs (N, 3, h, w) uint8")
    if interp not in INTERP_MODES:
        raise ValueError(f"interp must be one of {tuple(INTERP_MODES)}, got {interp!r}")
    n, _, h, w = planes.shape
    return (n, h, w) + _crop_geometry(h, w, None, out_size, None)


def _nv_geometry(batch, crop_rect, out_size, top):
    """(n, h, w, left, top, cw, ch, oh, ow) of a stacked NV batch (h the
    Y height), or ValueError."""
    if batch.dtype != torch.uint8 or batch.ndim != 3:
        raise ValueError("fused NV preprocess needs (N, H*3//2, W) uint8")
    n, hb, w = batch.shape
    if hb % 3 or w % 2:
        raise ValueError("NV buffer needs H*3//2 rows (a multiple of 3) and an even width")
    h = hb * 2 // 3
    return (n, h, w) + _crop_geometry(h, w, crop_rect, out_size, top)


def _clamped_top(top, top0, h, ch, device):
    """The crop top clamped to [0, h - ch], as the kernel clamps it: an
    int, or a 0-d int64 tensor on ``device`` for a tensor ``top``."""
    if isinstance(top, torch.Tensor):
        return torch.clamp(top.reshape(()).to(device=device, dtype=torch.int64), 0, h - ch)
    return min(max(top0 if top is None else int(top), 0), h - ch)


def _resample(planes, oh, ow, interp, trunc_u8, normalize, mean, stddev):
    """(N, 3, ch, cw) f32 crop planes → resize (vertical pass first) → u8
    epilogue → normalize: the shared tail of both plain versions."""
    ch, cw = planes.shape[-2:]
    wy = torch.from_numpy(_resize_weights(ch, oh, interp)).to(planes.device)
    wx = torch.from_numpy(_resize_weights(cw, ow, interp)).to(planes.device)
    out = torch.matmul(torch.matmul(wy, planes), wx.T)
    if trunc_u8:
        out = u8_epilogue(out, INTERP_MODES[interp])
    if normalize:
        out = normalize_planes(out, _static_stats(mean), _static_stats(stddev))
    return out.contiguous()


def preprocess_fused_batch_torch(
    batch,
    crop_rect=None,
    out_size=(224, 224),
    *,
    top=None,
    mean=None,
    stddev=None,
    normalize=True,
    trunc_u8=True,
    interp="linear",
):
    """Plain PyTorch version of the fused kernel: slice crop, the same
    dense weights through ``torch.matmul`` (vertical pass first), the u8
    epilogue, then normalization.  Runs on any device."""
    n, h, w, left, top0, cw, ch, oh, ow = _geometry(batch, crop_rect, out_size, interp, top)
    rows = dynamic_slice(batch, 1, _clamped_top(top, top0, h, ch, batch.device), ch)
    planes = rows[:, :, left : left + cw, :].permute(0, 3, 1, 2).to(torch.float32)
    return _resample(planes, oh, ow, interp, trunc_u8, normalize, mean, stddev)


def preprocess_fused_nv_batch_torch(
    batch,
    crop_rect=None,
    out_size=(224, 224),
    *,
    is_nv12=False,
    to_rgb=False,
    top=None,
    mean=None,
    stddev=None,
    normalize=True,
    trunc_u8=True,
):
    """Plain PyTorch version of the fused NV kernel: gather the crop's Y
    rows and, for each, its chroma row (from the absolute row, so any
    top parity is right), decode with torch int32 ops, then the same
    tail as ``preprocess_fused_batch_torch``, linear only.  Only the
    crop is decoded.  Runs on any device."""
    n, h, w, left, top0, cw, ch, oh, ow = _nv_geometry(batch, crop_rect, out_size, top)
    dev = batch.device
    rows = torch.arange(ch, device=dev) + _clamped_top(top, top0, h, ch, dev)
    cols = torch.arange(left, left + cw, device=dev)
    pair = cols - cols % 2  # a pixel's chroma pair starts at the even column
    y = batch.index_select(1, rows).index_select(2, cols).to(torch.int32)
    chroma = batch.index_select(1, h + rows // 2)
    first = chroma.index_select(2, pair).to(torch.int32)
    second = chroma.index_select(2, pair + 1).to(torch.int32)
    b, g, r = yuv_to_bgr_q7(y, first, second, is_nv12)
    planes = torch.stack((r, g, b) if to_rgb else (b, g, r), dim=1).to(torch.float32)
    return _resample(planes, oh, ow, "linear", trunc_u8, normalize, mean, stddev)


def preprocess_fused_planes_torch(planes, out_size, *, interp="linear", mean=None,
                                  stddev=None, normalize=True):
    """Plain PyTorch version of the fused kernel on (N, 3, h, w) u8 planes:
    the same tail as ``preprocess_fused_batch_torch`` (dense weights,
    vertical pass first, the u8 epilogue, then normalization) with no
    crop.  Runs on any device."""
    _, _, _, _, _, _, _, oh, ow = _planes_geometry(planes, out_size, interp)
    return _resample(planes.to(torch.float32), oh, ow, interp, True, normalize, mean, stddev)


def one_pass_stats(raw: torch.Tensor, mean=None, stddev=None):
    """(μ, 1 / (σ + 1e-6)) as f32 (N, 3) tensors, formed as the moments and
    one-pass kernels form them from the truncated (N, 3, oh, ow) planes
    ``raw`` (the ``normalize=False`` output, integer-valued): the integer
    moments Σx and Σx², μ = Σx · (1/N) and σ = √(N Σx² − (Σx)²) · (1/N) in
    double, then f32.  A static ``mean`` or ``stddev`` replaces its own, as
    in the plain version.  The kernels' output is ``(raw − μ) · (1 / (σ +
    1e-6))`` in f32, bit for bit."""
    x = raw.to(torch.int64).flatten(2)
    count = x.shape[-1]
    sx, sxx = x.sum(-1), (x * x).sum(-1)
    inv_n = 1.0 / count
    mu = (sx.double() * inv_n).float()
    sd = ((count * sxx - sx * sx).double().sqrt() * inv_n).float()
    for value, stat in ((_static_stats(mean), mu), (_static_stats(stddev), sd)):
        if value is not None:
            stat.copy_(torch.tensor(value, dtype=torch.float32).expand_as(stat))
    return mu, 1.0 / (sd + np.float32(1e-6))


@functools.lru_cache(maxsize=None)
def card_limits(device_index: int) -> CardLimits:
    """The card's and the NV one-pass kernel's limits, for ``launch_plan``."""
    return CardLimits(*build.limits("vacv_preprocess_limits", device_index, 4))


class FusedLaunch(build.Launch):
    """One call of the fused kernel, prepared (``_prepare``; the public
    ``prepare_fused_*`` functions below): a ``build.Launch`` that holds the
    tap tables and the scratch its arguments point at and, in the
    two-launch form, makes the normalize launch after the first.  Its tops:
    None, an int (clamped each call) or a tensor.  ``models/pipeline.py``
    keys its records by what a record runs.

    The scratch (the moments form's u8 planes and moments, the one-pass
    form's slots) is kept from call to call.  That is safe on the record's
    one stream because the first kernel of every call is an ordinary launch,
    not a programmatic dependent one: it starts only after the previous
    call's kernels on that stream have finished reading the scratch.  That
    is the same block reuse the caching allocator gives two calls on one
    stream."""

    __slots__ = ("norm", "norm_args")

    def __init__(self, name, device, shape):
        super().__init__(name, device, shape, torch.float32)
        self.norm = self.norm_args = None

    def run(self, batch, top=None, offset=0):
        """Launch the call on ``batch``, its source ``offset`` bytes past
        ``batch.data_ptr()``, with ``top``; returns the (N, 3, oh, ow) f32
        output, a new tensor every call.  Traced as span ``ops.<name>``."""
        return self._run(batch.data_ptr() + offset, top, None)

    def _more(self, out):
        if self.norm is not None:
            args = list(self.norm_args)
            args[2] = out.data_ptr()
            build.call(self.norm, args, f"{self.route} normalize kernel")


def _moments_scratch(n: int, oh: int, ow: int, device):
    """The moments form's scratch, kept by its record: the (n, 3, oh, ow) u8
    planes, then each resize block's moments (6 x 8 bytes) at a 16-byte
    boundary.  Returns (the tensor, the planes' address, the moments')."""
    at = -(-n * 3 * oh * ow // 16) * 16
    parts = -(-ow // 32) * -(-oh // 8)
    scratch = torch.empty(at + n * parts * 48, dtype=torch.uint8, device=device)
    return scratch, scratch.data_ptr(), scratch.data_ptr() + at


def _prepare(batch, geom, nv, top, mean, stddev, normalize, trunc_u8, interp, name, plan,
             planar=False) -> FusedLaunch:
    """The record of one call of ``name`` (``FusedLaunch``), for batches
    like ``batch`` and tops of ``top``'s kind: ``plan`` (``launch_plan``)
    "one_pass": the NV one-pass kernel alone; "moments": the resize launch
    to u8, then the scale launch; else launch 1 (the NV entry when ``nv`` is
    an (is_nv12, to_rgb) pair) and, for "two_launch", launch 2.  ``planar``:
    ``batch`` is (N, 3, h, w) planes, not (N, h, w, 3) frames."""
    n, h, w, left, top0, cw, ch, oh, ow = geom
    if not batch.is_contiguous():
        raise ValueError("fused preprocess kernel needs a contiguous batch")
    if n > _MAX_FRAMES:
        raise ValueError(f"fused preprocess kernel takes at most {_MAX_FRAMES} frames")
    dev = batch.device
    rec = FusedLaunch(name, dev, (n, 3, oh, ow))
    if n == 0:
        return rec
    if top is None:
        top0 = _clamped_top(None, top0, h, ch, dev)
    ys, yw = _device_taps(ch, oh, interp, dev)
    xs, xw = _device_taps(cw, ow, interp, dev)
    mean_s, std_s = _static_stats(mean), _static_stats(stddev)
    static_norm = bool(normalize) and mean_s is not None and std_s is not None
    zeros = (0.0, 0.0, 0.0)
    stats = (*(mean_s or zeros), *(std_s or zeros))
    have = (int(mean_s is not None), int(std_s is not None))
    rec.held = (ys, yw, xs, xw)
    head = (dev.index, stream_key(dev), None, None)  # the source and the output: per call
    taps = (left, ch, top0, None, oh, ow, ys.data_ptr(), yw.data_ptr(), yw.shape[1],
            xs.data_ptr(), xw.data_ptr(), xw.shape[1])
    eps = u8_eps(INTERP_MODES[interp])
    if plan.form == "one_pass":
        # each block's moments, 6 x 8 bytes
        slots = torch.empty(n * plan.blocks * 6, dtype=torch.int64, device=dev)
        rec.held += (slots,)
        entry, what = "vacv_preprocess_nv_one_pass", "one-pass kernel"
        front = head + (n, h, w, *map(int, nv))
        rest = (eps, plan.blocks, plan.rows, plan.chan, *have, int(plan.stream),
                slots.data_ptr(), *stats)
    elif plan.form == "moments":
        scratch, planes_at, slots_at = _moments_scratch(n, oh, ow, dev)
        rec.held += (scratch,)
        entry, what = "vacv_preprocess_moments", "moments kernels"
        front = head + (planes_at, slots_at, n, h, w, int(planar))
        rest = (eps, plan.blocks, *have, *stats)
    else:
        entry = "vacv_preprocess_nv_resize" if nv is not None else "vacv_preprocess_resize"
        what = "resize kernel"
        front = head + (n, h, w, *(map(int, nv) if nv is not None else (int(planar),)))
        norm_stats = (*(mean_s if static_norm else zeros), *(std_s if static_norm else zeros))
        rest = (int(trunc_u8), eps, int(static_norm), *norm_stats)
        if plan.form == "two_launch":
            rec.norm = build.entry("vacv_preprocess_normalize")
            rec.norm_args = (dev.index, head[1], None, n * 3, oh * ow, *have, *stats)
    rec.bind(entry, front + taps + rest, f"{name} {what}")
    rec.top_kind(top, len(front) + 3, len(front) + 2, h - ch)  # the taps' top, then its address
    return rec


def _plan(geom, source, lim, normalize, mean, stddev, trunc_u8, form="auto") -> Plan:
    self_stats = _static_stats(mean) is None or _static_stats(stddev) is None
    return launch_plan(geom[0], geom[-2], geom[-1], lim, source=source, normalize=bool(normalize),
                       self_stats=self_stats, trunc_u8=bool(trunc_u8), form=form)


def prepare_fused_batch(batch, crop_rect=None, out_size=(224, 224), *, top=None, mean=None,
                        stddev=None, normalize=True, trunc_u8=True,
                        interp="linear") -> FusedLaunch:
    """``preprocess_fused_batch``'s work on a CUDA batch that does not
    depend on the batch's data or the top's value, done ahead: the checks,
    the geometry, the plan, the tap tables and the arguments.  Its ``run(batch,
    top)`` launches it (``FusedLaunch``).  Raises ValueError as
    ``preprocess_fused_batch`` does."""
    geom = _geometry(batch, crop_rect, out_size, interp, top)
    plan = _plan(geom, "bgr", card_limits(batch.device.index), normalize, mean, stddev, trunc_u8)
    return _prepare(batch, geom, None, top, mean, stddev, normalize, trunc_u8, interp,
                    "preprocess_fused", plan)


def preprocess_fused_batch(
    batch,
    crop_rect=None,
    out_size=(224, 224),
    *,
    top=None,
    mean=None,
    stddev=None,
    normalize=True,
    trunc_u8=True,
    interp="linear",
):
    """Fused crop→resize→CHW→f32→normalize over a (N, H, W, 3) u8 batch.

    ``crop_rect``: VRect-like; ``top`` optionally overrides the rect's
    top with a runtime value (a Python int or a 0-d integer tensor; same
    row count), clamped to ``[0, H - ch]``.  ``mean`` / ``stddev`` are
    per-channel constants (None → per-image self-stats; a scalar
    broadcasts).  ``interp`` is ``"linear"``, ``"cubic"`` or
    ``"nearest"``.  Returns (N, 3, oh, ow) f32 on the batch's device.

    A CUDA batch launches the kernel (counted as ``"preprocess_fused"``)
    or raises: ``prepare_fused_batch``, then its ``run``.  A CPU batch runs
    the plain version (counted as ``"preprocess_fused_torch"``).  Raises
    ValueError for inputs the kernel does not take.
    """
    kwargs = dict(top=top, mean=mean, stddev=stddev, normalize=normalize, trunc_u8=trunc_u8,
                  interp=interp)
    return build.dispatch(
        "preprocess_fused", batch,
        lambda: prepare_fused_batch(batch, crop_rect, out_size, **kwargs).run(batch, top),
        lambda: preprocess_fused_batch_torch(batch, crop_rect, out_size, **kwargs))


def prepare_fused_nv_batch(batch, crop_rect=None, out_size=(224, 224), *, is_nv12=False,
                           to_rgb=False, top=None, mean=None, stddev=None, normalize=True,
                           trunc_u8=True, form="auto") -> FusedLaunch:
    """``preprocess_fused_nv_batch``'s work on a CUDA batch done ahead, as
    ``prepare_fused_batch``; raises ValueError as that wrapper does."""
    geom = _nv_geometry(batch, crop_rect, out_size, top)
    plan = _plan(geom, "nv", card_limits(batch.device.index), normalize, mean, stddev, trunc_u8,
                 form)
    return _prepare(batch, geom, (is_nv12, to_rgb), top, mean, stddev, normalize, trunc_u8,
                    "linear", "preprocess_fused_nv", plan)


def preprocess_fused_nv_batch(
    batch,
    crop_rect=None,
    out_size=(224, 224),
    *,
    is_nv12=False,
    to_rgb=False,
    top=None,
    mean=None,
    stddev=None,
    normalize=True,
    trunc_u8=True,
    form="auto",
):
    """Fused NV decode → crop → bilinear resize → CHW → f32 → normalize
    over a (N, H·3/2, W) u8 stacked NV batch (Y over interleaved VU:
    NV21 by default, ``is_nv12=True`` for UV order).

    Returns (N, 3, oh, ow) f32: B, G, R planes (R, G, B with
    ``to_rgb``).  ``crop_rect``, ``top``, ``mean``, ``stddev``,
    ``normalize`` and ``trunc_u8`` as in ``preprocess_fused_batch``; the
    resize is the Q11 bilinear one.  Any crop inside the frame is taken.
    ``form`` holds a call with self statistics to the kernel's "one_pass"
    or "two_launch" form (``launch_plan``).

    A CUDA batch launches the kernel (counted as
    ``"preprocess_fused_nv"``) or raises: ``prepare_fused_nv_batch``, then
    its ``run``.  A CPU batch runs the plain version (counted as
    ``"preprocess_fused_nv_torch"``).  Raises ValueError for inputs the
    kernel does not take (not u8 rank 3, rows not a multiple of 3, an odd
    width, a crop outside the frame) and for a form that cannot serve the
    call.
    """
    if form not in FORMS:
        raise ValueError(f"NV form must be one of {FORMS}, got {form!r}")
    kwargs = dict(is_nv12=is_nv12, to_rgb=to_rgb, top=top, mean=mean, stddev=stddev,
                  normalize=normalize, trunc_u8=trunc_u8)
    return build.dispatch(
        "preprocess_fused_nv", batch,
        lambda: prepare_fused_nv_batch(batch, crop_rect, out_size, form=form,
                                       **kwargs).run(batch, top),
        lambda: preprocess_fused_nv_batch_torch(batch, crop_rect, out_size, **kwargs))


def prepare_fused_planes(planes, out_size, *, interp="linear", mean=None, stddev=None,
                         normalize=True) -> FusedLaunch:
    """``preprocess_fused_planes``' work on CUDA planes done ahead, as
    ``prepare_fused_batch``; raises ValueError as that wrapper does."""
    geom = _planes_geometry(planes, out_size, interp)
    plan = _plan(geom, "planar", card_limits(planes.device.index), normalize, mean, stddev, True)
    return _prepare(planes, geom, None, None, mean, stddev, normalize, True, interp,
                    "preprocess_fused_planar", plan, planar=True)


class _WarpMomentsArgs(ctypes.Structure):
    """The fused warp's fixed arguments, made once a record and passed by
    address (``WarpMomentsArgs`` in ``csrc/preprocess_warp.cu``, field for
    field): a call converts six arguments where it would convert
    thirty-eight."""

    _fields_ = [*((k, ctypes.c_void_p) for k in ("planes", "slots", "ystart", "ywt", "xstart",
                                                   "xwt")),
                ("sn", ctypes.c_longlong), ("sy", ctypes.c_longlong),
                *((k, ctypes.c_int) for k in ("n", "h", "w", "rows_full", "h_out", "w_out", "oh",
                                               "ow", "ky", "kx", "blocks", "have_mean",
                                               "have_std")),
                ("m", ctypes.c_float * 6), ("eps", ctypes.c_float),
                ("mean", ctypes.c_float * 3), ("std", ctypes.c_float * 3)]


def prepare_fused_warp(planes, minv, h_out: int, w_out: int, out_size, *, row0=None, rows=None,
                       interp="linear", mean=None, stddev=None,
                       normalize=True) -> FusedLaunch | None:
    """``warp_planes_batch`` (linear, constant border 0, as the
    Preprocessor warps) followed by ``preprocess_fused_planes`` on its
    output, prepared as one call on the card that samples the warp only
    where the tail's resize reads it (``csrc/preprocess_warp.cu``): the
    same bits, no warped intermediate.  ``planes``, ``minv``, ``h_out``,
    ``w_out``, ``row0`` and ``rows`` as the warp takes them, the rest as
    the tail takes them.

    Returns the record (``FusedLaunch``, counted as
    ``"preprocess_fused_warp"``; its tops: none or a tensor ``row0``), or
    None where this form does not serve the pair: the warp's call does not
    take the 3-channel HWC form (``warp_affine.hwc3_form``: u8, three
    channels through an HWC view, 32-bit offsets), or the tail's plan is not
    the moments form (``launch_plan``: truncated output with a
    self-computed statistic).  Raises ValueError as the two wrappers do."""
    _check_warp(planes, InterMode.INTER_LINEAR, BorderMode.BORDER_CONSTANT, row0, rows)
    n = planes.shape[0]
    if interp not in INTERP_MODES:
        raise ValueError(f"interp must be one of {tuple(INTERP_MODES)}, got {interp!r}")
    if n == 0 or not hwc3_form(planes):
        return None
    *_, oh, ow = _crop_geometry(h_out, w_out, None, out_size, None)
    geom = (n, h_out, w_out, 0, 0, w_out, h_out, oh, ow)
    plan = _plan(geom, "planar", card_limits(planes.device.index), normalize, mean, stddev, True)
    if plan.form != "moments":
        return None
    dev = planes.device
    h_full, w = planes.shape[2:]
    h = h_full if rows is None else int(rows)
    ys, yw = _device_taps(h_out, oh, interp, dev)
    xs, xw = _device_taps(w_out, ow, interp, dev)
    mean_s, std_s = _static_stats(mean), _static_stats(stddev)
    zeros = (0.0, 0.0, 0.0)
    scratch, planes_at, slots_at = _moments_scratch(n, oh, ow, dev)
    sn, _, sy, _ = planes.stride()
    fixed = _WarpMomentsArgs(
        planes_at, slots_at, ys.data_ptr(), yw.data_ptr(), xs.data_ptr(), xw.data_ptr(), sn, sy,
        n, h, w, h_full, h_out, w_out, oh, ow, yw.shape[1], xw.shape[1], plan.blocks,
        int(mean_s is not None), int(std_s is not None),
        tuple(float(v) for v in np.asarray(minv, np.float32).reshape(6)),
        u8_eps(INTERP_MODES[interp]), mean_s or zeros, std_s or zeros)
    rec = FusedLaunch("preprocess_fused_warp", dev, (n, 3, oh, ow))
    rec.held = (ys, yw, xs, xw, fixed, scratch)
    rec.bind("vacv_preprocess_warp_moments",
             (dev.index, stream_key(dev), None, None, None, ctypes.addressof(fixed)),
             "preprocess_fused_warp moments kernels")
    rec.top_kind(row0, 4)  # the device top's address
    return rec


def preprocess_fused_planes(planes, out_size, *, interp="linear", mean=None, stddev=None,
                            normalize=True):
    """Resize → u8 truncation → normalize over (N, 3, h, w) u8 planes (the
    affine warp's output), the whole batch in one call: BASELINE config
    5's tail.

    ``out_size`` is (w, h); ``interp``, ``mean``, ``stddev`` and
    ``normalize`` as in ``preprocess_fused_batch``.  Returns (N, 3, oh, ow)
    f32 on the planes' device.  The resize takes the vertical pass first,
    as the fused kernels do; the chain's ``resize`` takes the pass order
    that costs fewer multiply-adds, so a value on the truncation boundary
    may come out one LSB apart from the chain's.

    A CUDA tensor (contiguous) launches the kernel, counted as
    ``"preprocess_fused_planar"``, or raises: ``prepare_fused_planes``, then
    its ``run``.  A CPU tensor runs the plain version, counted as
    ``"preprocess_fused_planar_torch"``.  Raises ValueError for inputs the
    kernel does not take (not (N, 3, h, w) u8, an interpolation other than
    linear, cubic or nearest)."""
    kwargs = dict(interp=interp, mean=mean, stddev=stddev, normalize=normalize)
    return build.dispatch(
        "preprocess_fused_planar", planes,
        lambda: prepare_fused_planes(planes, out_size, **kwargs).run(planes),
        lambda: preprocess_fused_planes_torch(planes, out_size, **kwargs))
