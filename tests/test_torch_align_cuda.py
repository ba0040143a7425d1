"""The alignment kernel on the card: ``pytest -m gpu tests/test_torch_align_cuda.py``.

``ops/cuda/align.py`` (``csrc/align.cu``) warps every face of a batch of
frames in one launch.  Each test holds its output bit for bit
(``torch.equal``) to the per-face chain it replaces, vacv's
``warp_affine_normalize`` on the card (the frame's planar copy, the warp
kernel, f32, the static normalize), planes reversed for RGB, and to the
plain version (``align_faces_torch``) on the CPU: small frames with faces
across their edges, scales below 0.5 and above 1 and rolls of ±30°, and
16 1080p frames with the cell's ~190 faces.  It counts one launch a batch
(the route counter and ``native.calls``), a record hit on the second batch
of a signature whatever its face count, no launch for K = 0, and NaN for a face whose frame index
lies outside the batch, the other faces untouched.  The ``cuda`` fixture
skips every test when PyTorch sees no CUDA device.  This file imports no
JAX.
"""
import numpy as np
import pytest
import torch

import vacv_tpu_torch as vt
from vacv_tpu_torch import config
from vacv_tpu_torch.models import Aligner
from vacv_tpu_torch.ops.cuda.align import align_faces, align_faces_torch

from align_reference import similarity

pytestmark = pytest.mark.gpu

STATS = ((104.0, 117.0, 123.0), (57.1, 57.4, 58.4))  # per output plane


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def faces(n, h, w, count, seed, out=112):
    """(index int32, matrices (K, 2, 3) f32) of ``count`` faces: centres
    anywhere in the frames (so some boxes cross an edge), sides from a
    quarter of the output to four times it, rolls within ±30°."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, n, count).astype(np.int32)
    sides = out * np.exp(r.uniform(np.log(0.25), np.log(4.0), count))
    mats = [similarity(r.uniform(0, w), r.uniform(0, h), s, r.uniform(-30, 30), out)
            for s in sides]
    return torch.from_numpy(idx), torch.from_numpy(np.stack(mats) if mats else
                                                   np.zeros((0, 2, 3), np.float32))


def frames_on(device, n, h, w, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=g, dtype=torch.uint8, device=device)


def per_face_chain(frames, index, matrices, dsize, mean, std, to_rgb):
    """vacv's warp_affine_normalize on each face's frame, as CHW planes in
    output order (the statistics reversed to the source's order for RGB)."""
    m, s = (tuple(reversed(v)) for v in (mean, std)) if to_rgb else (mean, std)
    outs = []
    for k, f in enumerate(index.tolist()):
        hwc = vt.warp_affine_normalize(frames[f], matrices[k].cpu().numpy(), dsize, mean=m,
                                       stddev=s).data
        chw = hwc.permute(2, 0, 1)
        outs.append(chw.flip(0) if to_rgb else chw)
    return torch.stack(outs)


@pytest.mark.parametrize("to_rgb", [False, True], ids=["bgr", "rgb"])
@pytest.mark.parametrize("shape,count,dsize", [((3, 64, 96), 9, (24, 24)),
                                               ((2, 120, 200), 7, (112, 112)),
                                               ((4, 90, 70), 11, (40, 56))],
                         ids=["64x96", "120x200", "90x70"])
def test_kernel_is_the_per_face_chain(cuda, to_rgb, shape, count, dsize):
    n, h, w = shape
    batch = frames_on(cuda, n, h, w, seed=h + count)
    index, mats = faces(n, h, w, count, seed=count, out=dsize[0])
    index, mats = index.to(cuda), mats.to(cuda)
    got = align_faces(batch, index, mats, dsize, *STATS, to_rgb=to_rgb)
    torch.cuda.synchronize()
    want = per_face_chain(batch, index.cpu(), mats.cpu(), dsize, *STATS, to_rgb)
    assert torch.equal(got, want)
    plain = align_faces_torch(batch.cpu(), index.cpu(), mats.cpu(), dsize, *STATS, to_rgb=to_rgb)
    assert torch.equal(got.cpu(), plain)


def test_1080p_batch_is_the_per_face_chain_in_one_launch(cuda):
    """The cell's shapes: 16 1080p frames, ~190 faces, ArcFace's input."""
    batch = frames_on(cuda, 16, 1080, 1920, seed=5)
    r = np.random.default_rng(6)
    count = int(r.integers(150, 230))
    idx = r.integers(0, 16, count).astype(np.int32)
    sides = np.exp(r.uniform(np.log(40), np.log(400), count))
    mats = np.stack([similarity(r.uniform(0, 1920), r.uniform(0, 1080), s, r.uniform(-30, 30))
                     for s in sides])
    index, matrices = torch.from_numpy(idx).to(cuda), torch.from_numpy(mats).to(cuda)
    aligner = Aligner(device=cuda)
    names = ("align_faces", "native.calls", "align.batches", "align.rois",
             "align.records_made", "align.record_hits")
    before = [config.kernel_count(k) for k in names]
    got = aligner.batch(batch, index, matrices)
    again = aligner.batch(batch, index, matrices)
    torch.cuda.synchronize()
    rose = [config.kernel_count(k) - b for k, b in zip(names, before)]
    assert rose == [2, 2, 2, 2 * count, 1, 1]
    assert torch.equal(got, again)
    want = per_face_chain(batch, index.cpu(), matrices.cpu(), (112, 112), (127.5,) * 3,
                          (127.5,) * 3, True)
    assert torch.equal(got, want)


def test_face_tables_of_several_counts_hit_one_record(cuda):
    """A camera batch has another face count almost every time: tables of
    7, 12, 3, 0 and 9 faces on one batch of frames make one record and hit
    it four times, one launch a table with faces, each output the plain
    version's."""
    n, h, w = 4, 120, 200
    batch = frames_on(cuda, n, h, w, seed=8)
    tables = [faces(n, h, w, count, seed=40 + count) for count in (7, 12, 3, 0, 9)]
    aligner = Aligner(device=cuda)
    names = ("align_faces", "align.records_made", "align.record_hits")
    before = [config.kernel_count(k) for k in names]
    outs = [aligner.batch(batch, index.to(cuda), mats.to(cuda)) for index, mats in tables]
    torch.cuda.synchronize()
    assert [config.kernel_count(k) - b for k, b in zip(names, before)] == [4, 1, 4]
    for (index, mats), got in zip(tables, outs):
        want = align_faces_torch(batch.cpu(), index, mats, (112, 112), (127.5,) * 3,
                                 (127.5,) * 3, to_rgb=True)
        assert torch.equal(got.cpu(), want)


def test_no_faces_no_launch(cuda):
    batch = frames_on(cuda, 2, 64, 96, seed=1)
    index = torch.zeros(0, dtype=torch.int32, device=cuda)
    mats = torch.zeros((0, 2, 3), dtype=torch.float32, device=cuda)
    before = config.kernel_count("native.calls")
    out = Aligner(device=cuda).batch(batch, index, mats)
    assert out.shape == (0, 3, 112, 112) and out.is_cuda
    assert config.kernel_count("native.calls") == before


def test_frame_index_outside_the_batch_is_nan(cuda):
    n, h, w = 3, 64, 96
    batch = frames_on(cuda, n, h, w, seed=2)
    index, mats = faces(n, h, w, 5, seed=3, out=24)
    bad = index.clone()
    bad[1], bad[3] = n, -1
    got = align_faces(batch, bad.to(cuda), mats.to(cuda), (24, 24), *STATS)
    want = align_faces(batch, index.to(cuda), mats.to(cuda), (24, 24), *STATS)
    torch.cuda.synchronize()
    assert torch.isnan(got[[1, 3]]).all()
    keep = [0, 2, 4]
    assert torch.equal(got[keep], want[keep])
