"""Hand-written CUDA kernels for Hopper (sources in ``vacv_tpu_torch/csrc``),
each beside its plain PyTorch version.  Importing builds nothing."""
from .preprocess import preprocess_fused_batch, preprocess_fused_batch_torch
