"""The cached device tables are keyed by the current CUDA stream.

A table evicted from an LRU cache goes back to PyTorch's caching allocator
on the stream it was made on, which hands its memory out again ordered
after that stream's work only.  ``core/device_tables.stream_cached`` keys
the three caches (the fused kernel's tap tables, the chain's resize
weights, the template matcher's box-sum bands) by the current stream, so a
table is only ever read on the stream that made it.  These tests stand a
mock stream handle in for ``torch.cuda.current_stream`` (there is no card
here); ``chip_smoke.py``'s serve phase checks the same on the card, bit for
bit under ``stream_map(depth=4)`` over more shapes than the cache holds.
"""
import importlib

import pytest
import torch

from vacv_tpu_torch import config
from vacv_tpu_torch.core import device_tables
from vacv_tpu_torch.ops.cuda import preprocess as pk

# the package exports functions of these names: import the modules themselves
tr = importlib.import_module("vacv_tpu_torch.ops.resize")
ws = importlib.import_module("vacv_tpu_torch.ops.cuda.window_sum")


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


@pytest.fixture
def stream(monkeypatch):
    """A settable stand-in for the current stream's handle."""
    current = {"handle": 1}
    monkeypatch.setattr(device_tables, "stream_key", lambda device: current["handle"])
    return current


def test_off_the_card_there_is_no_stream():
    assert device_tables.stream_key(torch.device("cpu")) is None


def test_a_table_is_only_handed_to_the_stream_that_made_it(stream):
    made = []

    @device_tables.stream_cached(maxsize=2)
    def table(n, device):
        made.append((n, stream["handle"]))
        return torch.full((n,), float(stream["handle"]))

    dev = torch.device("cpu")
    a = table(3, dev)
    assert table(3, dev) is a                       # the same stream: the cached table
    stream["handle"] = 2
    b = table(3, dev)
    assert b is not a and b[0] == 2                 # another stream: its own table
    assert made == [(3, 1), (3, 2)]
    # Eviction: a third table drops the oldest (stream 1's); stream 1 then
    # gets a new table made on stream 1, never stream 2's.
    table(4, dev)
    stream["handle"] = 1
    again = table(3, dev)
    assert again is not a and again is not b and again[0] == 1
    assert made == [(3, 1), (3, 2), (4, 2), (3, 1)]
    info = table.cache_info()
    assert (info.hits, info.misses, info.maxsize, info.currsize) == (1, 4, 2, 2)
    table.cache_clear()
    assert table.cache_info().currsize == 0


@pytest.mark.parametrize("name,make", [
    ("tap tables", lambda dev: pk._device_taps(37, 11, "cubic", dev)),
    ("resize weights", lambda dev: tr._device_weights(41, 57, 19, 23, 2, False, dev)),
    ("box-sum bands", lambda dev: (ws._ones_band(40, 5, dev),)),
])
def test_the_three_caches_are_keyed_by_stream(stream, name, make):
    """Each cache gives one stream's tables only to that stream: a second
    stream gets tables of its own (equal values, other tensors)."""
    dev = torch.device("cpu")
    first = make(dev)
    assert all(x is y for x, y in zip(make(dev), first)), name
    stream["handle"] = 7
    other = make(dev)
    assert all(x is not y and torch.equal(x, y) for x, y in zip(other, first)), name
    stream["handle"] = 1
    assert all(x is y for x, y in zip(make(dev), first)), name
