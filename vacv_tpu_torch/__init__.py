"""vacv_tpu_torch — the PyTorch/CUDA port of vacv_tpu, for an NVIDIA H100.

The same image-preprocessing engine as ``vacv_tpu`` (the JAX/Pallas
package beside it, which stays the reference), with its hot kernels
written by hand for Hopper.  This package holds the BASELINE config-4
slice, the NV camera slice, the warp path (config 5) and template
matching: crop, layout, dtype, resize, mean/stddev + normalize (with the
standalone normalize kernel, ``ops/cuda/normalize.py``), NV12/NV21
``cvt_color`` (with the yuv2bgr kernel, ``ops/cuda/yuv2bgr.py``), the fused
[NV decode →] crop→resize→normalize kernel (``ops/cuda/preprocess.py``),
``warp_affine`` (with the warp kernel, ``ops/cuda/warp_affine.py``), the
fused ``resize_normalize`` / ``warp_affine_normalize`` pipelines,
``match_template`` (with the correlation kernel,
``ops/cuda/match_template.py``) and the ``Preprocessor`` that routes to
them.  It imports ``torch`` and never ``jax``; CUDA kernels are built on
first use, so importing needs no ``nvcc`` and no GPU.
"""
from __future__ import annotations

from . import config
from .core.image import Image, as_array, as_image
from .core.types import (
    BorderMode,
    ColorCode,
    InterMode,
    Layout,
    MatchMode,
    VPoint,
    VRect,
    VScalar,
    VSize,
)
from .ops.crop import crop, crop_dynamic
from .ops.cvt_color import cvt_color
from .ops.dtype import change_dtype
from .ops.fused import resize_normalize, warp_affine_normalize, warp_affine_normalize_rot
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

HWC = Layout.HWC
CHW = Layout.CHW

__version__ = "0.1.0"

__all__ = [
    "Image", "as_image", "as_array", "config",
    "Layout", "InterMode", "BorderMode", "ColorCode", "MatchMode",
    "VSize", "VScalar", "VPoint", "VRect",
    "crop", "crop_dynamic", "cvt_color", "change_dtype", "change_layout",
    "resize", "mean_stddev", "normalize",
    "warp_affine", "warp_affine_rot", "get_rotation_matrix_2d", "invert_affine",
    "resize_normalize", "warp_affine_normalize", "warp_affine_normalize_rot",
    "match_template", "min_max_idx", "min_max_loc",
]
