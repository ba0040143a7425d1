"""mean_stddev + normalize (vacv ops #2 / #6 / #7).

The counterpart of ``vacv_tpu/ops/normalize.py``, with the reference's
semantics (``normalize_naive.cpp:7-90``, ``normalize.cpp:84-120``):

* input is converted to f32 first;
* σ is the *population* (biased) stddev, σ = sqrt(E[(x-μ)²]), taken
  around the image's own mean;
* the epsilon lives in the denominator: ``(x-μ)/(σ+1e-6)``.

The dispatcher ``normalize`` routes CHW float self-stats inputs to the
standalone normalize kernel (``ops/cuda/normalize.py``, the counterpart
of ``vacv_tpu/ops/pallas/normalize.py``) and everything else to
``normalize_torch``; the fused preprocess kernels normalize in their own
pass.
"""
from __future__ import annotations

import torch

from .. import config
from ..core.image import Image, as_image
from ..core.types import Layout

EPS = 1e-6


def _to_planes(img: Image):
    """(c, h, w) float32 planes of the image + whether it was 2-D."""
    data = img.data.to(torch.float32)
    if data.ndim == 2:
        return data[None], True
    if img.layout == Layout.HWC:
        return data.permute(2, 0, 1), False
    return data, False


def _stat_vector(v, c: int, like: torch.Tensor) -> torch.Tensor:
    """Caller-supplied per-channel stats as a float32 vector of length c
    on ``like``'s device (a scalar broadcasts)."""
    t = torch.as_tensor(v, dtype=torch.float32, device=like.device).reshape(-1)
    return t.expand(c) if t.numel() == 1 else t[:c]


def normalize_planes(planes: torch.Tensor, mean=None, stddev=None) -> torch.Tensor:
    """``(x - μ) / (σ + 1e-6)`` over the trailing (h, w) of
    (..., c, h, w) float32 planes.

    A stat left as None is computed per plane; a supplied one is a
    per-channel constant.  A partially supplied pair is honoured: the
    missing σ is taken around the plane's own mean even when a static
    mean is given (``normalize_jnp``, vacv_tpu/ops/normalize.py:84-108).
    """
    c = planes.shape[-3]
    shape = (1,) * (planes.ndim - 3) + (c, 1, 1)
    self_mean = None
    if mean is None or stddev is None:
        self_mean = planes.mean(dim=(-2, -1), keepdim=True)
    mu = self_mean if mean is None else _stat_vector(mean, c, planes).reshape(shape)
    if stddev is None:
        sd = torch.sqrt(torch.square(planes - self_mean).mean(dim=(-2, -1), keepdim=True))
    else:
        sd = _stat_vector(stddev, c, planes).reshape(shape)
    return (planes - mu) / (sd + EPS)


def mean_stddev(src):
    """Per-channel (mean, stddev) as float32 vectors of length C.

    Parity: the implicit mean/stddev computation inside
    ``Normalize::normalize`` when the caller passes empty tensors
    (normalize.cpp:96-112).
    """
    planes, _ = _to_planes(as_image(src))
    flat = planes.reshape(planes.shape[0], -1)
    mean = flat.mean(dim=1)
    var = torch.square(flat - mean[:, None]).mean(dim=1)
    return mean, torch.sqrt(var)


def normalize(src, mean=None, stddev=None) -> Image:
    """``(x - mean) / (stddev + 1e-6)`` per channel, f32 output.

    Parity: ``va_cv::normalize`` (cv.h:104-106).  When ``mean`` /
    ``stddev`` are None they are computed from the image itself
    (the reference's empty-tensor convention).

    Routing keeps the JAX package's rule (vacv_tpu/ops/normalize.py:
    70-81, measured on a TPU): under the ``auto`` backend a rank-3 CHW
    float image with both stats self-computed goes to the standalone
    normalize kernel's wrapper (``ops/cuda/normalize.py``: the CUDA
    kernel on a CUDA tensor, ``normalize_torch`` on a CPU tensor);
    everything else runs ``normalize_torch``.
    """
    img = as_image(src)
    if (
        config.use_fused()
        and mean is None
        and stddev is None
        and img.data.ndim == 3
        and img.layout == Layout.CHW
        and img.data.dtype != torch.uint8
    ):
        from .cuda.normalize import normalize_fused

        # The kernel reads f32: other types convert first, as
        # normalize_torch converts them.
        planes = img.data.to(torch.float32).contiguous()
        return img.with_data(normalize_fused(planes))
    return normalize_torch(img, mean, stddev)


def normalize_torch(src, mean=None, stddev=None) -> Image:
    """Plain PyTorch implementation."""
    img = as_image(src)
    planes, squeeze = _to_planes(img)
    out = normalize_planes(planes, mean, stddev)
    if squeeze:
        out = out[0]
    elif img.layout == Layout.HWC:
        out = out.permute(1, 2, 0).contiguous()
    return img.with_data(out)
