"""vacv_tpu_torch — the PyTorch/CUDA port of vacv_tpu, for an NVIDIA H100.

The same image-preprocessing engine as ``vacv_tpu`` (the JAX/Pallas
package beside it, which stays the reference), with its hot kernels
written by hand for Hopper.  This package holds the BASELINE config-4
slice and the NV camera slice: crop, layout, dtype, resize, mean/stddev +
normalize (with the standalone normalize kernel, ``ops/cuda/normalize.py``),
NV12/NV21 ``cvt_color`` (with the yuv2bgr kernel, ``ops/cuda/yuv2bgr.py``),
the fused [NV decode →] crop→resize→normalize kernel
(``ops/cuda/preprocess.py``) and the ``Preprocessor`` that routes to it.  It imports ``torch`` and never
``jax``; CUDA kernels are built on first use, so importing needs no
``nvcc`` and no GPU.
"""
from __future__ import annotations

from . import config
from .core.image import Image, as_array, as_image
from .core.types import (
    BorderMode,
    ColorCode,
    InterMode,
    Layout,
    VPoint,
    VRect,
    VScalar,
    VSize,
)
from .ops.crop import crop, crop_dynamic
from .ops.cvt_color import cvt_color
from .ops.dtype import change_dtype
from .ops.layout import change_layout
from .ops.normalize import mean_stddev, normalize
from .ops.resize import resize

INTER_NEAREST = InterMode.INTER_NEAREST
INTER_LINEAR = InterMode.INTER_LINEAR
INTER_CUBIC = InterMode.INTER_CUBIC
INTER_AREA = InterMode.INTER_AREA
INTER_LANCZOS4 = InterMode.INTER_LANCZOS4

COLOR_YUV2BGR_NV21 = ColorCode.COLOR_YUV2BGR_NV21
COLOR_YUV2BGR_NV12 = ColorCode.COLOR_YUV2BGR_NV12
COLOR_YUV2RGB_NV21 = ColorCode.COLOR_YUV2RGB_NV21
COLOR_YUV2RGB_NV12 = ColorCode.COLOR_YUV2RGB_NV12

HWC = Layout.HWC
CHW = Layout.CHW

__version__ = "0.1.0"

__all__ = [
    "Image", "as_image", "as_array", "config",
    "Layout", "InterMode", "BorderMode", "ColorCode",
    "VSize", "VScalar", "VPoint", "VRect",
    "crop", "crop_dynamic", "cvt_color", "change_dtype", "change_layout",
    "resize", "mean_stddev", "normalize",
]
