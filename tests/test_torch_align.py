"""Face alignment on the CPU: ``models.Aligner`` and
``ops/fused.py::warp_affine_normalize_batch`` (the alignment kernel's plain
version, ``ops/cuda/align.py::align_faces_torch``).

At a small size, 3 frames of 64x96 and 9 faces to 24x24 (scales below 0.5
and above 1, rolls of ±30°, boxes over every edge of the frame), and with
no faces:

* the Aligner agrees with the float64 reference of the chain
  (``tests/align_reference.py``) within the tolerances below;
* the batched route is bit for bit vacv's per-face chain,
  ``warp_affine_normalize`` on each face's frame with its matrix, planes
  reversed for RGB;
* that per-face chain agrees with the JAX package's
  ``vacv_tpu.warp_affine_normalize``, the oracle;
* the inverses are ``invert_affine``'s bit for bit, a singular matrix
  included; the counters count a batch, its faces and its route; the
  fixed arguments the card's launch passes (``_AlignArgs``) hold the call's
  shape, strides and statistics (against a fake kernel library);
* errors: a frame index outside the batch, a matrix table of the wrong
  shape, frames that are not u8, an index that is not int32, no statistics.

The card's tests are ``tests/test_torch_align_cuda.py`` (``-m gpu``).
"""
import ctypes
import types

import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu import config as jconfig
from vacv_tpu_torch import config
from vacv_tpu_torch.models import Aligner
from vacv_tpu_torch.ops.cuda import align as ak
from vacv_tpu_torch.ops.cuda import build
from vacv_tpu_torch.ops.fused import warp_affine_normalize_batch
from vacv_tpu_torch.utils import trace

import align_reference as ref

N, H, W, OUT = 3, 64, 96, 24
SEED = 2**31 + 2022
ARCFACE = ((127.5,) * 3, (127.5,) * 3)
STATS = ((104.0, 117.0, 123.0), (57.1, 57.4, 58.4))  # per output plane
# (frame, centre x, centre y, box side, roll): scale 24 / side below 0.5
# (side > 48) and above 1 (side < 24), rolls of ±30°, boxes across the
# left, right, top and bottom edges and a corner.
FACES = [(0, 30.0, 20.0, 20.0, 10.0), (1, 90.0, 5.0, 60.0, -30.0), (2, 50.0, 32.0, 12.0, 30.0),
         (1, 2.0, 60.0, 30.0, 0.0), (0, 48.0, 32.0, 90.0, 25.0), (2, 95.0, 63.0, 16.0, -12.0),
         (0, 70.0, 40.0, 24.0, -30.0), (2, 10.0, 2.0, 50.0, 17.0), (1, 60.0, 50.0, 8.0, 3.0)]
# The reference's tolerances.  The program blends four Q11-weighted bytes in
# f32, where a sum can need up to 30 bits: a value whose exact fraction sits
# just below the truncation boundary can come out one u8 step up or down,
# rarely.  Its normalize rounds in f32: ~1e-5 of a step.  So a value may be
# one step off (plus that rounding), and at most one value in a thousand.
MAX_LSB = 1 + 1e-3
OFF_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


def inputs(faces=FACES, seed=SEED):
    frames = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (N, H, W, 3),
                                                                     dtype=np.uint8))
    index = torch.tensor([f[0] for f in faces], dtype=torch.int32)
    mats = np.stack([ref.similarity(x, y, s, r, OUT) for _, x, y, s, r in faces]) if faces \
        else np.zeros((0, 2, 3), np.float32)
    return frames, index, torch.from_numpy(mats)


def lsb_gaps(got, want, std):
    """|got - want| in u8 steps, the plane's std + 1e-6 a step."""
    s = torch.as_tensor(std, dtype=torch.float64).reshape(1, 3, 1, 1) + ref.NORM_EPS
    return (got.to(torch.float64) - want).abs() * s


@pytest.mark.parametrize("stats", [ARCFACE, STATS], ids=["arcface", "per_channel"])
@pytest.mark.parametrize("to_rgb", [True, False], ids=["rgb", "bgr"])
def test_aligner_agrees_with_the_reference(to_rgb, stats):
    frames, index, mats = inputs()
    got = Aligner((OUT, OUT), *stats, to_rgb=to_rgb).batch(frames, index, mats)
    want = ref.align(frames, index.numpy(), mats.numpy(), (OUT, OUT), *stats, to_rgb)
    assert got.shape == want.shape == (len(FACES), 3, OUT, OUT) and got.dtype == torch.float32
    gaps = lsb_gaps(got, want, stats[1])
    print(f"max {gaps.max().item():.6f} LSB, {(gaps > 0.5).float().mean().item():.2e} off")
    assert gaps.max() <= MAX_LSB
    assert (gaps > 0.5).float().mean() <= OFF_SHARE
    # the faces are not all border: each reads the frame somewhere
    assert all((want[k] != want[k, :, :1, :1]).any() for k in range(len(FACES)))


def per_face_chain(frames, index, mats, dsize, mean, std, to_rgb):
    """``warp_affine_normalize`` on each face's frame, CHW in output order."""
    m, s = (tuple(reversed(v)) for v in (mean, std)) if to_rgb else (mean, std)
    outs = []
    for k, f in enumerate(index.tolist()):
        chw = vt.warp_affine_normalize(frames[f], mats[k].numpy(), dsize, mean=m,
                                       stddev=s).data.permute(2, 0, 1)
        outs.append(chw.flip(0) if to_rgb else chw)
    return torch.stack(outs)


@pytest.mark.parametrize("stats", [ARCFACE, STATS], ids=["arcface", "per_channel"])
@pytest.mark.parametrize("to_rgb", [True, False], ids=["rgb", "bgr"])
@pytest.mark.parametrize("dsize", [(OUT, OUT), (20, 28)], ids=["24x24", "20x28"])
def test_batch_is_the_per_face_chain_bit_for_bit(dsize, to_rgb, stats):
    frames, index, mats = inputs()
    got = warp_affine_normalize_batch(frames, index, mats, dsize, *stats, to_rgb=to_rgb)
    assert torch.equal(got, per_face_chain(frames, index, mats, dsize, *stats, to_rgb))


@pytest.mark.parametrize("k", range(len(FACES)))
def test_per_face_chain_agrees_with_the_jax_package(k):
    """The oracle: vacv_tpu's warp_affine_normalize (its jnp route) on the
    same face.  The packages share the u8 arithmetic, so the u8 steps
    recovered from the two agree within one step (a truncation flip)."""
    frames, index, mats = inputs()
    f = int(index[k])
    src = frames[f].numpy()
    with jconfig.backend("jnp"):
        want = np.asarray(vc.warp_affine_normalize(src, mats[k].numpy(), (OUT, OUT),
                                                   mean=STATS[0], stddev=STATS[1]).data)
    got = vt.warp_affine_normalize(frames[f], mats[k].numpy(), (OUT, OUT), mean=STATS[0],
                                   stddev=STATS[1]).numpy()
    assert got.shape == want.shape == (OUT, OUT, 3)
    steps = np.abs(got.astype(np.float64) - want) * (np.asarray(STATS[1]) + 1e-6)
    print(f"max {steps.max():.6f} LSB")
    assert steps.max() <= MAX_LSB
    assert (steps > 0.5).mean() <= OFF_SHARE


def test_no_faces():
    frames, index, mats = inputs(faces=[])
    before = config.kernel_count("align_faces_torch")
    out = Aligner((OUT, OUT)).batch(frames, index, mats)
    assert out.shape == (0, 3, OUT, OUT) and out.dtype == torch.float32
    assert config.kernel_count("align_faces_torch") == before + 1


def test_inverses_are_invert_affine():
    _, _, mats = inputs()
    mats = torch.cat([mats, torch.tensor([[[2.0, 4.0, 1.0], [1.0, 2.0, 3.0]]])])  # singular
    got = ak.inverse_matrices(mats).numpy()
    want = np.stack([vt.invert_affine(m).reshape(6) for m in mats.numpy()])
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got[-1].any()


def test_counters_and_span():
    frames, index, mats = inputs()
    names = ("align.batches", "align.rois", "align_faces_torch")
    before = [config.kernel_count(k) for k in names]
    trace.enable()
    trace.reset()
    try:
        aligner = Aligner((OUT, OUT))
        assert aligner.route() == "align_faces_torch"
        for _ in range(2):
            aligner.batch(frames, index, mats)
        spans = trace.snapshot()["spans"]
    finally:
        trace.disable()
        trace.reset()
    assert [config.kernel_count(k) - b for k, b in zip(names, before)] == [2, 2 * len(FACES), 2]
    assert spans["align.batch"]["count"] == 2
    assert spans["ops.align_faces_torch"]["count"] == 2


@pytest.mark.parametrize("case", ["index_high", "index_negative", "matrix_shape", "matrix_dtype",
                                  "frames_f32", "frames_gray", "index_int64", "no_stats"])
def test_errors(case):
    frames, index, mats = inputs()
    stats = ARCFACE
    if case == "index_high":
        index[3] = N
    elif case == "index_negative":
        index[0] = -1
    elif case == "matrix_shape":
        mats = mats.reshape(-1, 3, 2)
    elif case == "matrix_dtype":
        mats = mats.double()
    elif case == "frames_f32":
        frames = frames.float()
    elif case == "frames_gray":
        frames = frames[..., 0]
    elif case == "index_int64":
        index = index.long()
    else:
        stats = (None, None)
    error = IndexError if case.startswith("index_") and case != "index_int64" else ValueError
    with pytest.raises(error):
        warp_affine_normalize_batch(frames, index, mats, (OUT, OUT), *stats)


def fake_library(monkeypatch, calls):
    """A kernel library whose alignment entry records its positional
    arguments and the ``_AlignArgs`` they point at (no card here)."""
    def fn(*args):
        fixed = ak._AlignArgs.from_address(args[7])
        calls.append((args, {k: getattr(fixed, k) for k, _ in ak._AlignArgs._fields_}))
        return 0

    monkeypatch.setattr(build, "library",
                        lambda: types.SimpleNamespace(lib=types.SimpleNamespace(
                            vacv_align_faces=fn)))
    build.entry.cache_clear()


def test_fixed_arguments_of_the_card_launch(monkeypatch):
    """``prepare_align_faces`` packs the frames' shape and strides, the
    output size, the plane order and the statistics into ``_AlignArgs``,
    and its ``run`` passes the four addresses and K: held against a fake
    kernel library."""
    calls = []
    fake_library(monkeypatch, calls)
    try:
        frames, index, mats = inputs()
        view = frames[:, 2:50, 4:90]  # a crop view: rows of the whole frame apart
        rec = ak.prepare_align_faces(view, index, mats, (20, 28), *STATS, to_rgb=True)
        before = config.kernel_count("align_faces")
        out = rec.run(view, index, mats)
        empty = ak.prepare_align_faces(view, index[:0], mats[:0], (20, 28), *STATS)
        assert empty.run(view, index[:0], mats[:0]).shape == (0, 3, 28, 20)
    finally:
        build.entry.cache_clear()
    assert out.shape == (len(FACES), 3, 28, 20)
    assert config.kernel_count("align_faces") == before + 1
    assert len(calls) == 1
    args, fixed = calls[0]
    assert args[2:7] == (view.data_ptr(), out.data_ptr(), index.data_ptr(), mats.data_ptr(),
                         len(FACES))
    assert {k: fixed[k] for k in ("sn", "sy", "n", "h", "w", "oh", "ow", "to_rgb")} == dict(
        sn=H * W * 3, sy=W * 3, n=N, h=48, w=86, oh=28, ow=20, to_rgb=1)
    assert list(fixed["mean"]) == list(np.float32(STATS[0]))
    assert list(fixed["std"]) == list(np.float32(STATS[1]))
    assert fixed["eps"] == ctypes.c_float(1e-6).value


def test_one_record_runs_face_tables_of_any_count(monkeypatch):
    """A record is made for the frames alone: tables of 9, 4, 0 and 7 faces
    all run through the one made for the first, each with its own K and
    addresses (K = 0 launches nothing); a table that does not go with the
    frames is refused by the record."""
    calls = []
    fake_library(monkeypatch, calls)
    try:
        frames, index, mats = inputs()
        rec = ak.prepare_align_faces(frames, index, mats, (OUT, OUT), *ARCFACE, to_rgb=True)
        outs = [rec.run(frames, index[:k].contiguous(), mats[:k].contiguous())
                for k in (9, 4, 0, 7)]
        with pytest.raises(ValueError):
            rec.run(frames, index[:3], mats[:4])
        with pytest.raises(ValueError):
            rec.run(frames, index.long(), mats)
        with pytest.raises(ValueError):
            rec.run(frames, index[::2], mats[::2])
    finally:
        build.entry.cache_clear()
    assert [o.shape[0] for o in outs] == [9, 4, 0, 7]
    assert [args[6] for args, _ in calls] == [9, 4, 7]
    assert len({args[7] for args, _ in calls}) == 1  # one _AlignArgs for every K
    for (args, _), out in zip(calls, (outs[0], outs[1], outs[3])):
        assert args[2:6] == (frames.data_ptr(), out.data_ptr(), index.data_ptr(), mats.data_ptr())
