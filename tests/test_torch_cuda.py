"""The CUDA kernels on the card: ``pytest -m gpu tests/test_torch_cuda.py``.

Each test takes the ``cuda`` fixture, which skips when PyTorch sees no
CUDA device, so on a CPU-only host the whole file skips.  The kernel is
held to its plain PyTorch version on the same CUDA tensors: cosine >=
1-1e-6 and max-abs < 0.05 normalized; at most 1 LSB on under 1e-3 of
the values with ``normalize=False``.
"""
import pytest
import torch

from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import VRect
from vacv_tpu_torch.ops.cuda.preprocess import (
    preprocess_fused_batch,
    preprocess_fused_batch_torch,
)
from vacv_tpu_torch.utils.compare import cosine_similarity

pytestmark = pytest.mark.gpu

RECT = VRect(17, 20, 617, 340)
OUT = (112, 96)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def batch_on(device, n=4, h=360, w=640, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=g, dtype=torch.uint8,
                         device=device)


def cosine(a, b):
    return cosine_similarity(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("interp", ["linear", "cubic", "nearest"])
@pytest.mark.parametrize("stats", ["self", "static", "mean_only", "raw"])
def test_kernel_matches_plain_version(cuda, interp, stats):
    kw = {
        "self": {},
        "static": dict(mean=(104.0, 117.0, 123.0), stddev=(57.1, 57.4, 58.4)),
        "mean_only": dict(mean=(104.0, 117.0, 123.0)),
        "raw": dict(normalize=False),
    }[stats]
    batch = batch_on(cuda)
    got = preprocess_fused_batch(batch, RECT, OUT, interp=interp, **kw)
    torch.cuda.synchronize()
    want = preprocess_fused_batch_torch(batch, RECT, OUT, interp=interp, **kw)
    assert got.device == cuda and got.shape == want.shape == (4, 3, OUT[1], OUT[0])
    d = (got - want).abs()
    if stats == "raw":
        assert d.max().item() <= 1.0 and (d > 0).double().mean().item() < 1e-3
    else:
        assert cosine(got, want) >= 1 - 1e-6 and d.max().item() < 0.05


def test_runtime_top_device_tensor_and_clamp(cuda):
    batch = batch_on(cuda, seed=1)
    a = preprocess_fused_batch(batch, RECT, OUT, top=9)
    b = preprocess_fused_batch(batch, RECT, OUT,
                               top=torch.tensor(9, dtype=torch.int32, device=cuda))
    far = preprocess_fused_batch(batch, RECT, OUT, top=torch.tensor(10_000, device=cuda))
    bottom = preprocess_fused_batch(batch, RECT, OUT, top=360 - 320)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(far, bottom)


def test_launch_counter_rises_once_per_call(cuda):
    batch = batch_on(cuda, n=2, seed=2)
    k0 = config.kernel_count("preprocess_fused")
    p0 = config.kernel_count("preprocess_fused_torch")
    preprocess_fused_batch(batch, RECT, OUT)                       # two launches
    preprocess_fused_batch(batch, RECT, OUT, normalize=False)      # one launch
    torch.cuda.synchronize()
    assert config.kernel_count("preprocess_fused") == k0 + 2
    assert config.kernel_count("preprocess_fused_torch") == p0


def test_cpu_tensor_never_counts_a_launch(cuda):
    batch = batch_on(cuda, n=1, seed=3).cpu()
    k0 = config.kernel_count("preprocess_fused")
    preprocess_fused_batch(batch, RECT, OUT)
    assert config.kernel_count("preprocess_fused") == k0


def test_wrapper_raises_on_inputs_the_kernel_does_not_take(cuda):
    batch = batch_on(cuda, n=2, seed=4)
    k0 = config.kernel_count("preprocess_fused")
    with pytest.raises(ValueError, match="contiguous"):
        preprocess_fused_batch(batch[:, :, ::2], VRect(0, 0, 300, 300), OUT)
    with pytest.raises(ValueError, match="uint8"):
        preprocess_fused_batch(batch.float(), RECT, OUT)
    with pytest.raises(ValueError):
        preprocess_fused_batch(batch, RECT, OUT, top=torch.tensor(1.5, device=cuda))
    assert config.kernel_count("preprocess_fused") == k0
