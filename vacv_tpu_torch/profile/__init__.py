"""The harness layer: ``CvProfile`` and the tensor-core probe script
(``python -m vacv_tpu_torch.profile.probe_i8``)."""
from .runner import CvProfile, TestFuncInfo, TestResult
