"""The tensor-core probe's plain version and wrapper on the CPU.

The JAX probe's kernel (``benchmarks/probe_i8.py::_mk.kernel``) has no
interpret mode, so ``probe_dot_torch`` is held to the probe's own
reference expression, ``sum(an[r:r+M] @ bn for r in range(reps))`` in
float64 (``probe_i8.py:69-71``), with the probe's integer operands, at
reduced shapes and at the probe's first full shape.  Every partial sum
there is an integer below 2^24, so both types are held bit for bit.  The
kernel itself is compared with ``probe_dot_torch`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from vacv_tpu_torch import config
from vacv_tpu_torch.ops.cuda import probe
from vacv_tpu_torch.ops.cuda.probe import probe_dot, probe_dot_torch
from vacv_tpu_torch.profile import probe_i8


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


TYPES = {"bf16": (torch.bfloat16, torch.float32), "i8": (torch.int8, torch.int32)}


def probe_operands(seed, m, k, n, reps):
    rng = np.random.default_rng(seed)
    return rng.integers(-100, 100, (m + reps, k)), rng.integers(-2, 3, (k, n))


def reference(an, bn, reps):
    """benchmarks/probe_i8.py:69-71, in float64."""
    an, bn = np.asarray(an, np.float64), np.asarray(bn, np.float64)
    m = an.shape[0] - reps
    return sum(an[r : r + m] @ bn for r in range(reps))


@pytest.mark.parametrize("kind", list(TYPES))
@pytest.mark.parametrize("m,k,n,reps", [
    (96, 128, 2048, 64),            # the probe's first section, full size
    (7, 32, 9, 1), (37, 64, 75, 5), (70, 160, 130, 70), (96, 32, 64, 64),
])
def test_plain_version_matches_the_probe_reference(kind, m, k, n, reps):
    dtype, out_dtype = TYPES[kind]
    an, bn = probe_operands(m + k + n + reps, m, k, n, reps)
    got = probe_dot_torch(torch.from_numpy(an).to(dtype), torch.from_numpy(bn).to(dtype), reps)
    assert got.dtype == out_dtype and got.shape == (m, n)
    want = reference(an, bn, reps)
    assert np.abs(want).max() < 2**24  # every partial sum is exact in f32
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


def test_plain_version_of_random_bf16_rounds_the_float64_sum_once():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(40, 48))).to(torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=(48, 33))).to(torch.bfloat16)
    got = probe_dot_torch(a, b, 8)
    want = reference(a.float().numpy(), b.float().numpy(), 8)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_int8_sums_are_exact_at_the_extremes():
    """The largest magnitudes int8 takes, summed over K and reps, stay
    exact (the f64 sum is cast through int64)."""
    a = torch.full((3, 1024), 127, dtype=torch.int8)
    b = torch.full((1024, 2), 127, dtype=torch.int8)
    assert (probe_dot_torch(a, b, 2).numpy() == 127 * 127 * 1024 * 2).all()
    big = torch.full((70, 32), -128, dtype=torch.int8)
    wide = torch.full((32, 1), -128, dtype=torch.int8)
    assert probe_dot_torch(big, wide, 69).item() == 2**14 * 32 * 69


def test_wrapper_on_cpu_counts_the_plain_version():
    an, bn = probe_operands(1, 12, 32, 16, 4)
    a, b = torch.from_numpy(an).to(torch.int8), torch.from_numpy(bn).to(torch.int8)
    k0, p0 = config.kernel_count("probe_dot"), config.kernel_count("probe_dot_torch")
    assert torch.equal(probe_dot(a, b, 4), probe_dot_torch(a, b, 4))
    assert config.kernel_count("probe_dot_torch") == p0 + 1
    assert config.kernel_count("probe_dot") == k0


@pytest.mark.parametrize("a_shape,b_shape,dtypes,reps", [
    ((20, 32), (32, 8), (torch.float32, torch.float32), 4),   # not bf16/int8
    ((20, 32), (32, 8), (torch.bfloat16, torch.int8), 4),     # mixed
    ((20,), (32, 8), (torch.int8, torch.int8), 4),            # not 2-D
    ((20, 32), (16, 8), (torch.int8, torch.int8), 4),         # K differs
    ((4, 32), (32, 8), (torch.int8, torch.int8), 4),          # no row left for M
    ((20, 32), (32, 8), (torch.int8, torch.int8), 0),         # no rep
])
def test_wrapper_raises_on_operands_it_does_not_take(a_shape, b_shape, dtypes, reps):
    a, b = torch.zeros(a_shape, dtype=dtypes[0]), torch.zeros(b_shape, dtype=dtypes[1])
    with pytest.raises(ValueError):
        probe_dot(a, b, reps)
    with pytest.raises(ValueError):
        probe_dot_torch(a, b, reps)


def test_kernel_checks_run_before_any_launch():
    """What only the kernel refuses (K granule, strided or misaligned
    rows) raises in the launch path before the card is touched."""
    b16 = torch.zeros((24, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        probe._launch(torch.zeros((12, 24), dtype=torch.bfloat16), b16, 4)
    b8 = torch.zeros((48, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 32"):
        probe._launch(torch.zeros((12, 48), dtype=torch.int8), b8, 4)
    cols = torch.zeros((32, 12), dtype=torch.int8).T  # rows not contiguous
    with pytest.raises(ValueError, match="contiguous rows"):
        probe._launch(cols, torch.zeros((32, 8), dtype=torch.int8), 4)
    odd = torch.zeros(12 * 32 + 1, dtype=torch.int8)[1:].view(12, 32)  # misaligned start
    with pytest.raises(ValueError, match="16-byte"):
        probe._launch(odd, torch.zeros((32, 8), dtype=torch.int8), 4)
    with pytest.raises(ValueError, match="no probe_dot route"):
        probe_dot(torch.zeros((12, 32), dtype=torch.int8, device="meta"),
                  torch.zeros((32, 8), dtype=torch.int8, device="meta"), 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_probe_script_case_at_a_small_shape(dtype, capsys):
    """The probe script's case on the CPU: checked bit for bit, timed, no share
    of a card's peak printed."""
    res = probe_i8.run_case("small", 24, 32, 16, 3, dtype, np.random.default_rng(0),
                            torch.device("cpu"), check=True)
    assert res["ok"] is True and res["us"] > 0 and res["library_us"] > 0
    assert res["bound_us"] == 2 * 24 * 32 * 16 * 3 / probe_i8.PEAK_OPS[dtype] * 1e6
    assert "% of" not in capsys.readouterr().out


def test_library_operands_lay_the_windows_side_by_side():
    an, bn = probe_operands(2, 10, 32, 8, 5)
    a, b = torch.from_numpy(an).to(torch.int8), torch.from_numpy(bn).to(torch.int8)
    wide, tall = probe_i8.library_operands(a, b, 5)
    assert wide.shape == (10, 160) and tall.shape == (160, 8)
    assert torch.equal(probe_i8.library_call(wide, tall), probe_dot_torch(a, b, 5))


def test_step_slides_a_one_row_window():
    an, bn = probe_operands(3, 10, 32, 8, 5)
    a2 = torch.from_numpy(np.concatenate([an, an[:1]])).to(torch.int8)
    b = torch.from_numpy(bn).to(torch.int8)
    assert torch.equal(probe_i8.step(0, a2, b, 5), probe_dot_torch(a2[:-1], b, 5))
    assert torch.equal(probe_i8.step(1, a2, b, 5), probe_dot_torch(a2[1:], b, 5))


@pytest.mark.parametrize("m,n,reps,sms,splits", [
    (1024, 1024, 32, 132, 1),   # 16 x 8 = 128 tiles already fill the card
    (96, 2048, 64, 132, 4),     # 2 x 16 = 32 tiles: four blocks a tile
    (96, 1024, 64, 132, 8),     # 16 tiles: eight blocks a tile
    (96, 1024, 67, 132, 8),     # reps not a multiple of the split: 9, 9, ..., 4
    (96, 2048, 1, 132, 1),      # one rep: nothing to split
    (96, 2048, 5, 132, 1),      # under one rep for each warpgroup of a second block
    (17, 9, 24, 132, 8),        # one tile: three reps a block, one for each warpgroup
    (70, 130, 70, 132, 18),     # 4 tiles, 23 splits at most: 4 reps a split, the last 2
    (130, 200, 7, 132, 2),      # 6 tiles; 7 reps fill two blocks of three warpgroups
    (96, 2048, 64, 16, 1),      # a small card: the tiles fill it
])
def test_split_plan_fills_the_card(m, n, reps, sms, splits):
    """How many blocks share a tile's reps (csrc/probe_mma.cu): enough for a
    block on every SM, at least one rep for each of a block's three
    warpgroups, and no split left empty."""
    got = probe.split_plan(m, n, reps, sms)
    assert got == splits
    per = -(-reps // got)
    assert (got - 1) * per < reps  # the last split has reps
