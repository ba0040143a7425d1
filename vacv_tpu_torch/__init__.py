"""vacv_tpu_torch — the PyTorch/CUDA port of vacv_tpu, for an NVIDIA H100.

The same image-preprocessing engine as ``vacv_tpu`` (the JAX/Pallas
package beside it, which stays the reference), with its hot kernels
written by hand for Hopper, and the same flat ``va_cv::``-style facade:
every name of ``vacv_tpu.__all__`` and its constants.  Ops: crop, layout,
dtype, resize, mean/stddev + normalize (with the standalone normalize
kernel, ``ops/cuda/normalize.py``), ``cvt_color`` for every code (the NV
decode through the yuv2bgr kernel, ``ops/cuda/yuv2bgr.py``), the fused
[NV decode →] crop→resize→normalize kernel (``ops/cuda/preprocess.py``),
``warp_affine`` (with the warp kernel, ``ops/cuda/warp_affine.py``), the
fused ``resize_normalize`` / ``warp_affine_normalize`` pipelines,
``match_template`` (with the correlation and window-sum kernels,
``ops/cuda/match_template.py``, ``ops/cuda/window_sum.py``), host-side
``imencode``, and the
``Preprocessor`` that routes to them.  The harness layer: ``utils/perf``
(CUDA-event timing), ``profile`` (``CvProfile`` and the tensor-core
probe, ``ops/cuda/probe.py``), ``utils/io``, ``utils/loader`` and
``native`` (the C++ host library).

A numpy input goes to the card unless the caller asks for the CPU
(``config.device("cpu")``); a tensor is processed where it lies.  It
imports ``torch`` and never ``jax``; CUDA kernels are built on first
use, so importing needs no ``nvcc`` and no GPU.
"""
from __future__ import annotations

from . import config
from .core.image import Image, as_array, as_image
from .core.types import (
    BorderMode,
    ColorCode,
    ExtreSize,
    IndexValue,
    InterMode,
    Layout,
    MatchMode,
    NormalAlg,
    SimpleSize,
    VAngle,
    VEyeInfo,
    VMatrix,
    VPoint,
    VPoint3,
    VRect,
    VScalar,
    VSize,
)
from .ops.crop import crop, crop_dynamic
from .ops.cvt_color import cvt_color
from .ops.dtype import change_dtype
from .ops.fused import resize_normalize, warp_affine_normalize, warp_affine_normalize_rot
from .ops.imencode import imencode
from .ops.layout import change_layout
from .ops.match_template import match_template, min_max_idx, min_max_loc
from .ops.normalize import mean_stddev, normalize
from .ops.resize import resize
from .ops.warp_affine import get_rotation_matrix_2d, invert_affine, warp_affine, warp_affine_rot

INTER_NEAREST = InterMode.INTER_NEAREST
INTER_LINEAR = InterMode.INTER_LINEAR
INTER_CUBIC = InterMode.INTER_CUBIC
INTER_AREA = InterMode.INTER_AREA
INTER_LANCZOS4 = InterMode.INTER_LANCZOS4
INTER_MAX = InterMode.INTER_MAX
WARP_INVERSE_MAP = InterMode.WARP_INVERSE_MAP
BORDER_CONSTANT = BorderMode.BORDER_CONSTANT
BORDER_REPLICATE = BorderMode.BORDER_REPLICATE
BORDER_REFLECT = BorderMode.BORDER_REFLECT
BORDER_WRAP = BorderMode.BORDER_WRAP
BORDER_REFLECT_101 = BorderMode.BORDER_REFLECT_101
BORDER_REFLECT101 = BorderMode.BORDER_REFLECT_101  # cv.h:45 alias
BORDER_DEFAULT = BorderMode.BORDER_DEFAULT
BORDER_TRANSPARENT = BorderMode.BORDER_TRANSPARENT
BORDER_ISOLATED = BorderMode.BORDER_ISOLATED
TM_SQDIFF = MatchMode.TM_SQDIFF
TM_SQDIFF_NORMED = MatchMode.TM_SQDIFF_NORMED
TM_CCORR = MatchMode.TM_CCORR
TM_CCORR_NORMED = MatchMode.TM_CCORR_NORMED
TM_CCOEFF = MatchMode.TM_CCOEFF
TM_CCOEFF_NORMED = MatchMode.TM_CCOEFF_NORMED

COLOR_YUV2BGR_NV21 = ColorCode.COLOR_YUV2BGR_NV21
COLOR_YUV2BGR_NV12 = ColorCode.COLOR_YUV2BGR_NV12
COLOR_YUV2RGB_NV21 = ColorCode.COLOR_YUV2RGB_NV21
COLOR_YUV2RGB_NV12 = ColorCode.COLOR_YUV2RGB_NV12
COLOR_GRAY2BGR = ColorCode.COLOR_GRAY2BGR
COLOR_GRAY2RGB = ColorCode.COLOR_GRAY2RGB
COLOR_YUV2BGR_YV12 = ColorCode.COLOR_YUV2BGR_YV12
COLOR_BGR2RGB = ColorCode.COLOR_BGR2RGB
COLOR_RGB2BGR = ColorCode.COLOR_RGB2BGR
COLOR_BGR2GRAY = ColorCode.COLOR_BGR2GRAY
COLOR_RGB2GRAY = ColorCode.COLOR_RGB2GRAY
COLOR_BGR2BGRA = ColorCode.COLOR_BGR2BGRA
COLOR_BGRA2BGR = ColorCode.COLOR_BGRA2BGR
COLOR_GRAY2BGRA = ColorCode.COLOR_GRAY2BGRA

HWC = Layout.HWC
CHW = Layout.CHW

__version__ = "0.2.0"

__all__ = [
    "Image", "as_image", "as_array", "config",
    "Layout", "InterMode", "BorderMode", "MatchMode", "ColorCode",
    "NormalAlg", "VSize", "VScalar", "VPoint", "VPoint3", "VRect",
    "VAngle", "VEyeInfo", "VMatrix", "SimpleSize", "ExtreSize", "IndexValue",
    "crop", "crop_dynamic", "cvt_color", "change_dtype", "change_layout",
    "resize", "mean_stddev", "normalize", "warp_affine", "warp_affine_rot",
    "get_rotation_matrix_2d", "invert_affine",
    "resize_normalize", "warp_affine_normalize", "warp_affine_normalize_rot",
    "match_template", "min_max_idx", "min_max_loc", "imencode",
]
