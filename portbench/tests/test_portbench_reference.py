"""The plain reference on tiny inputs checked by hand, and against the
program's CPU routes at small sizes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import check, reference, systems
from portbench.tests.helpers import small_cell


def test_linear_taps_by_hand():
    s, w0, w1 = reference.linear_taps(4, 2)  # maps 0.5 and 2.5
    assert s.tolist() == [0, 2] and w0.tolist() == [0.5, 0.5] and w1.tolist() == [0.5, 0.5]
    s, w0, w1 = reference.linear_taps(2, 4)  # -0.25 (clamped), 0.25, 0.75, 1.25 (clamped)
    assert s.tolist() == [0, 0, 0, 0]
    assert w0.tolist() == [1.0, 0.75, 0.25, 0.0] and w1.tolist() == [0.0, 0.25, 0.75, 1.0]
    _, w0, w1 = reference.linear_taps(7, 3)  # fractions 1/6 and 5/6 snap to the Q11 grid
    assert np.all(w0 * 2048 == np.round(w0 * 2048)) and np.all(w0 + w1 == 1)


def test_identity_warp_equals_the_crop():
    g = torch.Generator().manual_seed(1)
    planes = torch.randint(0, 256, (2, 3, 9, 13), dtype=torch.uint8, generator=g)
    out = reference.warp(planes, reference.invert_affine([[1, 0, 0], [0, 1, 0]]), 9, 13,
                         torch.float64)
    assert torch.equal(reference.truncate_u8(out), planes.to(torch.float64))


def test_shifted_warp_reads_the_border_as_zero():
    planes = torch.full((1, 1, 4, 4), 200, dtype=torch.uint8)
    out = reference.warp(planes, reference.invert_affine([[1, 0, 2], [0, 1, 0]]), 4, 4,
                         torch.float64)
    assert out[0, 0, :, :2].eq(0).all() and out[0, 0, :, 2:].eq(200).all()


def test_inverse_matrix():
    m = np.array([[0.9, 0.03, 40.0], [-0.03, 0.9, 25.0]])
    inv = reference.invert_affine(m).astype(np.float64)
    full = np.vstack([m, [0, 0, 1]]) @ np.vstack([inv, [0, 0, 1]])
    assert np.allclose(full, np.eye(3), atol=1e-5)


def test_a_constant_image_normalizes_to_zero():
    frames = torch.full((2, 60, 80, 3), 77, dtype=torch.uint8)
    _, cfg, _ = small_cell("cfg4.resident")
    out, std = reference.chain(frames, cfg, 2)
    assert torch.equal(out, torch.zeros_like(out)) and torch.equal(std, torch.zeros_like(std))


def test_resize_of_a_ramp_by_hand():
    planes = torch.arange(4, dtype=torch.float64).reshape(1, 1, 1, 4) * 10  # 0 10 20 30
    out = reference.resize(planes, 1, 2)
    assert out.flatten().tolist() == [5.0, 25.0]


@pytest.mark.parametrize("name", ["cfg4.resident", "cfg5.resident"])
def test_the_program_agrees_with_the_reference_on_the_cpu(name):
    _, cfg, _ = small_cell(name)
    from portbench import inputs

    frames = inputs.frames(cfg, 3, 99, 0, "cpu")
    prog = systems.Program(cfg, "cpu")
    tally = check.Tally()
    for top in (0, 1, 10**6):
        ref, std = check.reference_of(frames, cfg, top)
        tally.add(prog.batch(frames, torch.tensor(top, dtype=torch.int32)), ref, std)
    numbers = tally.numbers()
    assert numbers["off_share"] <= cfg["limits"]["off_share"]
    assert numbers["max_err_lsb"] <= cfg["limits"]["max_err_lsb"]


@pytest.mark.parametrize("name", ["cfg4_fused_1080p", "cfg5_warp_1440p"])
def test_the_default_chain_is_the_reference_chain_bit_for_bit(name):
    """A configuration without ``chain`` makes the same frames and tops and
    the same float64 reference, at its own size, as the harness's modules."""
    from portbench import inputs, manifest

    cfg = manifest.config(manifest.load(), {"config": name})
    chain = manifest.chain(cfg)
    seed = 2**31 + 3
    frames = chain.frames(cfg, 1, seed, 0, "cpu")
    assert torch.equal(frames, inputs.frames(cfg, 1, seed, 0, "cpu"))
    tops = chain.tops(cfg, 3, seed, 1)
    assert tops == inputs.tops(cfg, 3, seed, 1)
    ref = chain.reference(frames, cfg, tops[0])
    assert ref.dtype == torch.float64
    assert torch.equal(ref, reference.chain(frames, cfg, tops[0])[0])
    assert isinstance(chain.system("program", cfg, "cpu"), systems.Program)
    assert isinstance(chain.system("control", cfg, "cpu"), systems.Control)
