"""vacv_tpu_torch.models.serving against vacv_tpu.models.serving.

``stream_map`` and ``StreamExecutor`` over ``Preprocessor.fn``: seven
frames at depth 1, 3 and 10, numpy frames and tensor frames.  Results come
in submission order, bit for bit the port's own ``pre.fn`` on each frame,
and at cosine >= 1 - 1e-4 against the JAX package's stream; the handing
back of results follows the JAX discipline step by step.  On the CPU the
same code runs without streams.
"""
import numpy as np
import pytest
import torch

import vacv_tpu as vc
from vacv_tpu.models import PreprocessConfig as JConfig
from vacv_tpu.models import Preprocessor as JPre
from vacv_tpu.models.serving import StreamExecutor as JStreamExecutor
from vacv_tpu.models.serving import stream_map as j_stream_map
from vacv_tpu.utils.compare import cosine_similarity
from vacv_tpu_torch import config
from vacv_tpu_torch.core.types import VRect
from vacv_tpu_torch.models import PreprocessConfig, Preprocessor, StreamExecutor, stream_map


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


N_FRAMES = 7
RECT, OUT = (4, 2, 52, 38), (24, 24)


@pytest.fixture(scope="module")
def pipelines():
    pre = Preprocessor(PreprocessConfig(crop_rect=VRect(*RECT), out_size=OUT), device="cpu")
    jpre = JPre(JConfig(crop_rect=vc.VRect(*RECT), out_size=OUT))
    return pre, jpre.fn


@pytest.fixture(scope="module")
def frames():
    return list(np.random.default_rng(11).integers(0, 256, (N_FRAMES, 40, 60, 3), dtype=np.uint8))


def inputs(frames, kind):
    return frames if kind == "numpy" else [torch.from_numpy(f) for f in frames]


def check(got, want_port, want_jax) -> None:
    assert len(got) == len(want_port) == len(want_jax) == N_FRAMES
    for g, p, j in zip(got, want_port, want_jax):
        assert torch.equal(g, p)
        j = np.asarray(j)
        cos = cosine_similarity(g.numpy(), j)
        print(f"vs JAX: 1-cos={1 - cos} max_abs={np.max(np.abs(g.numpy() - j))}")
        assert cos >= 1 - 1e-4


@pytest.mark.parametrize("depth", [1, 3, 10])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_stream_map_matches_jax(pipelines, frames, depth, kind):
    pre, jfn = pipelines
    got = list(stream_map(pre.fn, inputs(frames, kind), depth=depth))
    check(got, [pre.fn(f) for f in frames], list(j_stream_map(jfn, frames, depth=depth)))


@pytest.mark.parametrize("depth", [1, 3, 10])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_stream_executor_matches_jax(pipelines, frames, depth, kind):
    """``submit`` hands back the oldest result exactly where the JAX
    executor does (None until ``depth`` are pending); ``drain`` the rest."""
    pre, jfn = pipelines
    ex, jex = StreamExecutor(pre.fn, depth), JStreamExecutor(jfn, depth)
    handed = [ex.submit(f) for f in inputs(frames, kind)]
    jhanded = [jex.submit(f) for f in frames]
    assert [h is None for h in handed] == [h is None for h in jhanded]
    got = [h for h in handed if h is not None] + list(ex.drain())
    want_jax = [h for h in jhanded if h is not None] + list(jex.drain())
    check(got, [pre.fn(f) for f in frames], want_jax)
    assert list(ex.drain()) == []


@pytest.mark.parametrize("depth", [1, 3, 10])
def test_at_most_depth_in_flight(frames, depth):
    """Between submissions, no more than ``depth`` frames have been run and
    not yet handed back."""
    ran = []

    def fn(x):
        ran.append(len(ran))
        return x.float().mean()

    handed = 0
    for out in stream_map(fn, frames, depth=depth):
        assert len(ran) - handed <= depth
        handed += 1
    assert handed == len(ran) == N_FRAMES


def test_serving_the_preprocessor_itself(pipelines, frames):
    """A Preprocessor is served as it is (its ``__call__``), tensors stay on
    the device they lie on."""
    pre, _ = pipelines
    got = list(stream_map(pre, frames, depth=2))
    assert all(torch.equal(g, pre(f)) and g.device.type == "cpu" for g, f in zip(got, frames))


def test_depth_below_one_raises(pipelines, frames):
    pre, jfn = pipelines
    with pytest.raises(ValueError):
        list(stream_map(pre.fn, frames, depth=0))
    with pytest.raises(ValueError):
        StreamExecutor(pre.fn, depth=0)
    with pytest.raises(ValueError):
        list(j_stream_map(jfn, frames, depth=0))
    with pytest.raises(ValueError):
        JStreamExecutor(jfn, depth=0)


def test_numpy_frames_need_a_card_unless_the_cpu_is_asked_for(pipelines, monkeypatch):
    pre, _ = pipelines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with config.device("cuda"), pytest.raises(RuntimeError, match=r'config\.device\("cpu"\)'):
        StreamExecutor(pre.fn)
