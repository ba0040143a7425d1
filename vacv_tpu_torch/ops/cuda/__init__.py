"""Hand-written CUDA kernels for Hopper (sources in ``vacv_tpu_torch/csrc``),
each beside its plain PyTorch version.  Importing builds nothing."""
from .match_template import corr_planes, corr_planes_torch
from .normalize import normalize_fused
from .preprocess import (
    preprocess_fused_batch,
    preprocess_fused_batch_torch,
    preprocess_fused_nv_batch,
    preprocess_fused_nv_batch_torch,
)
from .probe import probe_dot, probe_dot_torch
from .warp_affine import warp_planes_batch, warp_planes_batch_torch
from .yuv2bgr import nv_to_bgr
