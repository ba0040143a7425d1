"""Launch records: a CUDA batch's launch prepared once for its signature.

``Preprocessor.batch`` keeps, for each ``launch_signature`` of a CUDA batch
(backend preference, shape, strides, type, device, current stream, kind of
top), a record of its launch: ``FusedLaunch`` on the fused routes, a warp
record on the warp route: one ``FusedLaunch`` of the fused warp
(``prepare_fused_warp``) where it serves the batch, else the warp's
``WarpLaunch`` and the planar tail's ``FusedLaunch``.  A later batch of the
signature only runs the record.

There is no card here: these tests run the records on CPU tensors against a
fake kernel library that keeps the arguments of every call, with a settable
stand-in for the current stream's handle.  They hold each argument tuple,
field by field, to the tuple the wrappers packed before the records existed
(``parent_fused_args`` and ``parent_warp_args`` below, that packing written
out), and the fused warp's to ``fused_warp_args``, its entry's arguments
written out.  ``tests/test_torch_cuda.py`` holds a hit, a miss and the public
wrapper to the same bits on the card.
"""
import ctypes
import dataclasses
import types

import numpy as np
import pytest
import torch

from vacv_tpu_torch import config
from vacv_tpu_torch.core import device_tables
from vacv_tpu_torch.core.types import ColorCode, InterMode, VRect
from vacv_tpu_torch.models import PreprocessConfig, Preprocessor
from vacv_tpu_torch.models import pipeline
from vacv_tpu_torch.ops.cuda import build, warp_affine
from vacv_tpu_torch.ops.cuda import preprocess as pk
from vacv_tpu_torch.ops.resize import u8_eps
from vacv_tpu_torch.utils import trace

RECT = VRect(4, 6, 60, 42)
OUT = (16, 12)
WARP = (((0.9, 0.03, 4.0), (-0.03, 0.9, 2.5)), (40, 30))
CFG4 = PreprocessConfig(crop_rect=RECT, out_size=OUT)
CFG5 = PreprocessConfig(crop_rect=VRect(2, 3, 62, 45), warp=WARP, out_size=OUT)
LIMITS = [132, 2048, 232448, 233472]  # an H100's, as vacv_preprocess_limits gives them
# where each entry takes the top's address (the crop top just before it)
TOP_PTR = {"vacv_preprocess_moments": 13, "vacv_preprocess_resize": 11,
           "vacv_preprocess_nv_resize": 12, "vacv_preprocess_nv_one_pass": 12,
           "vacv_warp_affine": 30, "vacv_preprocess_warp_moments": 4}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


@pytest.fixture
def lib(monkeypatch):
    """The kernel library replaced by fakes that keep (name, args, the int32
    the top's address holds) of every call, and the current stream's handle
    by ``stream["handle"]``."""
    calls = []
    stream = {"handle": 0x5EED}

    def fake(name):
        def fn(*args):
            if name == "vacv_preprocess_limits":
                out = ctypes.cast(args[1], ctypes.POINTER(ctypes.c_int))
                for i, v in enumerate(LIMITS):
                    out[i] = v
                return 0
            at = TOP_PTR.get(name)
            top = None
            if at is not None and args[at] is not None:
                top = ctypes.c_int32.from_address(args[at]).value
            if name == "vacv_preprocess_warp_moments":  # its fixed arguments, field by field
                args = args[:5] + flat_fields(pk._WarpMomentsArgs.from_address(args[5]))
            calls.append((name, args, top))
            return 0
        return fn

    names = ["vacv_preprocess_limits", "vacv_preprocess_normalize", "vacv_warp_affine",
             *TOP_PTR]
    fake_lib = types.SimpleNamespace(**{n: fake(n) for n in names})
    monkeypatch.setattr(build, "library", lambda: types.SimpleNamespace(lib=fake_lib))
    key = lambda device: stream["handle"]  # noqa: E731
    for module in (device_tables, pk, warp_affine, pipeline):
        monkeypatch.setattr(module, "stream_key", key)
    caches = [build.entry, pk.card_limits, pk._device_taps]
    for c in caches:
        c.cache_clear()
    yield types.SimpleNamespace(calls=calls, stream=stream)
    for c in caches:
        c.cache_clear()


def frames(n=2, h=48, w=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, generator=g)


def parent_fused_args(batch, out, geom, nv, top, mean, stddev, normalize, trunc_u8, interp,
                      plan, planar, stream, scratch=None):
    """The argument tuples of the library calls the fused wrappers made
    before the records (their ``_launch``, the calls taken out), with the
    scratch at ``scratch``: [(entry, args)]."""
    n, h, w, left, top0, cw, ch, oh, ow = geom
    dev = batch.device
    top_ptr = None
    if isinstance(top, torch.Tensor):
        top_ptr = top.reshape(()).to(device=dev, dtype=torch.int32).data_ptr()
    else:
        top0 = pk._clamped_top(top, top0, h, ch, dev)
    ys, yw = pk._device_taps(ch, oh, interp, dev)
    xs, xw = pk._device_taps(cw, ow, interp, dev)
    mean_s, std_s = pk._static_stats(mean), pk._static_stats(stddev)
    static_norm = bool(normalize) and mean_s is not None and std_s is not None
    zeros = (0.0, 0.0, 0.0)
    stats = (*(mean_s or zeros), *(std_s or zeros))
    have = (int(mean_s is not None), int(std_s is not None))
    taps = (left, ch, top0, top_ptr, oh, ow, ys.data_ptr(), yw.data_ptr(), yw.shape[1],
            xs.data_ptr(), xw.data_ptr(), xw.shape[1])
    eps = u8_eps(pk.INTERP_MODES[interp])
    if plan.form == "one_pass":
        return [("vacv_preprocess_nv_one_pass",
                 (dev.index, stream, batch.data_ptr(), out.data_ptr(), n, h, w, *map(int, nv),
                  *taps, eps, plan.blocks, plan.rows, plan.chan, *have, int(plan.stream),
                  scratch, *stats))]
    if plan.form == "moments":
        at = -(-n * 3 * oh * ow // 16) * 16
        return [("vacv_preprocess_moments",
                 (dev.index, stream, batch.data_ptr(), out.data_ptr(), scratch, scratch + at, n,
                  h, w, int(planar), *taps, eps, plan.blocks, *have, *stats))]
    norm_stats = (*(mean_s if static_norm else zeros), *(std_s if static_norm else zeros))
    if nv is not None:
        calls = [("vacv_preprocess_nv_resize",
                  (dev.index, stream, batch.data_ptr(), out.data_ptr(), n, h, w, *map(int, nv),
                   *taps, int(trunc_u8), eps, int(static_norm), *norm_stats))]
    else:
        calls = [("vacv_preprocess_resize",
                  (dev.index, stream, batch.data_ptr(), out.data_ptr(), n, h, w, int(planar),
                   *taps, int(trunc_u8), eps, int(static_norm), *norm_stats))]
    if plan.form == "two_launch":
        calls.append(("vacv_preprocess_normalize",
                      (dev.index, stream, out.data_ptr(), n * 3, oh * ow, *have, *stats)))
    return calls


def parent_warp_args(planes, minv, h_out, w_out, out, stream, row0=None, rows=None):
    """The warp wrapper's argument tuple before the records (its
    ``_launch``, the call taken out; linear, constant border 0, "auto")."""
    n, c, h_full, w = planes.shape
    h = h_full if rows is None else int(rows)
    top = None if row0 is None else row0.reshape(()).to(dtype=torch.int32)
    m = np.asarray(minv, np.float32).reshape(6)
    return ("vacv_warp_affine",
            (planes.device.index, stream, planes.data_ptr(), int(planes.dtype == torch.uint8), n,
             c, h, w, *planes.stride(), out.data_ptr(), h_out, w_out, *out.stride(),
             *(float(v) for v in m), 1, 0, 0.0, 0, 0, None if top is None else top.data_ptr(),
             h_full))


def flat_fields(struct) -> tuple:
    """A ctypes structure's fields in order, arrays spread."""
    out = []
    for name, _ in struct._fields_:
        v = getattr(struct, name)
        out += list(v) if isinstance(v, ctypes.Array) else [v]
    return tuple(out)


def fused_warp_args(planes, minv, h_out, w_out, out, stream, scratch, out_size, row0=None,
                    rows=None, interp="linear", mean=None, stddev=None):
    """The fused warp's argument tuple, its fixed arguments spread as the
    fake library spreads them: the warp of ``planes`` (as
    ``parent_warp_args`` takes them) and the moments form's tail over its
    output, with the scratch at ``scratch``."""
    n, _, h_full, w = planes.shape
    dev = planes.device
    ow, oh = out_size
    ys, yw = pk._device_taps(h_out, oh, interp, dev)
    xs, xw = pk._device_taps(w_out, ow, interp, dev)
    blocks = pk._scale_blocks(n, oh, ow, pk.card_limits(None))
    at = -(-n * 3 * oh * ow // 16) * 16
    mean_s, std_s = pk._static_stats(mean), pk._static_stats(stddev)
    zeros = (0.0, 0.0, 0.0)
    f32 = lambda v: float(np.float32(v))  # noqa: E731  (a float field's value)
    return ("vacv_preprocess_warp_moments",
            (dev.index, stream, planes.data_ptr(), out.data_ptr(),
             None if row0 is None else row0.data_ptr(), scratch, scratch + at, ys.data_ptr(),
             yw.data_ptr(), xs.data_ptr(), xw.data_ptr(), planes.stride(0), planes.stride(2), n,
             h_full if rows is None else rows, w, h_full, h_out, w_out, oh, ow, yw.shape[1],
             xw.shape[1], blocks, int(mean_s is not None), int(std_s is not None),
             *np.asarray(minv, np.float32).reshape(6).tolist(),
             f32(u8_eps(pk.INTERP_MODES[interp])), *(mean_s or zeros), *(std_s or zeros)))


def only_calls(lib):
    return [(name, args) for name, args, _ in lib.calls]


# --- the signature ----------------------------------------------------------

def _on_card(arr, index):
    """``arr`` as ``launch_signature`` would see it on card ``index``."""
    return types.SimpleNamespace(shape=arr.shape, stride=arr.stride, dtype=arr.dtype,
                                 get_device=lambda: index, device=arr.device)


BASE = frames(2)
MISSES = {
    "shape": lambda s: (frames(3), s["top"]),
    "strides": lambda s: (frames(2, w=128)[:, :, :64], s["top"]),
    "dtype": lambda s: (BASE.float(), s["top"]),
    "device": lambda s: (_on_card(BASE, 1), s["top"]),
    "stream": lambda s: (s.update(handle=2) or BASE, s["top"]),
    "backend": lambda s: (s.update(backend="torch") or BASE, s["top"]),
    "top_tensor_to_none": lambda s: (BASE, None),
    "top_tensor_to_int": lambda s: (BASE, 5),
    "top_tensor_dtype": lambda s: (BASE, torch.tensor(5, dtype=torch.int64)),
}


@pytest.mark.parametrize("change", list(MISSES))
def test_a_signature_changes_with_what_the_record_is_made_from(lib, change):
    """Each of these changes gives another signature, so another record."""
    state = {"top": torch.tensor(5, dtype=torch.int32), "backend": "auto"}
    first = pipeline.launch_signature(BASE, state["top"])
    state["handle"] = lib.stream["handle"]
    arr, top = MISSES[change](state)
    lib.stream["handle"] = state["handle"]
    with config.backend(state["backend"]):
        assert pipeline.launch_signature(arr, top) != first


@pytest.mark.parametrize("first,then", [
    ((BASE, None), (frames(2, seed=1), None)),                        # the data and its address
    ((BASE, 3), (BASE, 17)),                                          # an int top's value
    ((BASE, torch.tensor(3, dtype=torch.int32)),
     (BASE, torch.tensor(40, dtype=torch.int32))),                    # a tensor top's value
    ((BASE, None), (BASE.clone(), None)),                             # a copy of the batch
], ids=["data_ptr", "int_top_value", "tensor_top_value", "another_tensor"])
def test_a_signature_ignores_the_data_and_the_tops_value(lib, first, then):
    assert pipeline.launch_signature(*first) == pipeline.launch_signature(*then)


def test_the_top_kind_none_int_and_tensor_are_three_signatures(lib):
    tops = [None, 7, torch.tensor(7, dtype=torch.int32)]
    assert len({pipeline.launch_signature(BASE, t) for t in tops}) == 3


# --- the argument tuples ------------------------------------------------------

FUSED_CASES = {
    "moments_none_top": (dict(), None),
    "moments_int_top": (dict(), 9),
    "moments_int_top_clamped": (dict(), -4),
    "moments_int32_top": (dict(), torch.tensor(11, dtype=torch.int32)),
    "moments_int64_top": (dict(), torch.tensor([13], dtype=torch.int64)),
    "resize_only_static_stats": (dict(mean=(104.0, 117.0, 123.0), stddev=57.0), 3),
    "two_launch_untruncated": (dict(trunc_u8=False, interp="cubic"), None),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_a_bgr_record_packs_the_wrappers_arguments(lib, case):
    kw, top = FUSED_CASES[case]
    kw = dict(dict(mean=None, stddev=None, normalize=True, trunc_u8=True, interp="linear"), **kw)
    batch = frames(2)
    rec = pk.prepare_fused_batch(batch, RECT, OUT, top=top, **kw)
    out = rec.run(batch, top)
    geom = pk._geometry(batch, RECT, OUT, kw["interp"], top)
    plan = pk._plan(geom, "bgr", pk.card_limits(None), kw["normalize"], kw["mean"],
                    kw["stddev"], kw["trunc_u8"])
    scratch = rec.held[-1].data_ptr() if plan.form == "moments" else None
    want = parent_fused_args(batch, out, geom, None, top, kw["mean"], kw["stddev"],
                             kw["normalize"], kw["trunc_u8"], kw["interp"], plan, False,
                             0x5EED, scratch)
    got = only_calls(lib)
    if isinstance(top, torch.Tensor) and top.dtype != torch.int32:
        # a cast copy: another address, holding the same top
        at = TOP_PTR[got[0][0]]
        assert lib.calls[0][2] == int(top)
        got = [(n, a[:at] + a[at + 1:]) for n, a in got]
        want = [(n, a[:at] + a[at + 1:]) for n, a in want]
    elif isinstance(top, torch.Tensor):
        assert got[0][1][TOP_PTR[got[0][0]]] == top.data_ptr()  # by its own address
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            assert a == b, (case, i, a, b)


@pytest.mark.parametrize("form,top", [("auto", torch.tensor(5, dtype=torch.int32)),
                                      ("auto", None), ("two_launch", 7)])
def test_an_nv_record_packs_the_wrappers_arguments(lib, form, top):
    nv = torch.randint(0, 256, (2, 72, 64), dtype=torch.uint8)
    rect = VRect(2, 4, 62, 40)
    rec = pk.prepare_fused_nv_batch(nv, rect, OUT, is_nv12=True, to_rgb=True, top=top, form=form)
    out = rec.run(nv, top)
    geom = pk._nv_geometry(nv, rect, OUT, top)
    plan = pk._plan(geom, "nv", pk.card_limits(None), True, None, None, True, form)
    assert plan.form == ("one_pass" if form == "auto" else "two_launch")
    scratch = rec.held[-1].data_ptr() if plan.form == "one_pass" else None
    want = parent_fused_args(nv, out, geom, (True, True), top, None, None, True, True, "linear",
                             plan, False, 0x5EED, scratch)
    assert only_calls(lib) == want


# The warp route's tails: the fused warp where the tail takes the moments
# form (self statistics, a static mean alone, cubic), the warp and the planar
# tail where it does not (static statistics, normalize=False).
WARP_TAILS = {
    "fused": dict(),
    "fused_static_mean": dict(mean=(104.0, 117.0, 123.0)),
    "fused_cubic": dict(interpolation=InterMode.INTER_CUBIC),
    "two_launch_static_stats": dict(mean=(104.0, 117.0, 123.0), stddev=(57.0, 57.0, 58.0)),
    "two_launch_normalize_false": dict(normalize=False),
}


@pytest.mark.parametrize("tail", list(WARP_TAILS))
def test_the_warp_records_pack_the_wrappers_arguments(lib, tail):
    """Config 5's route, with each kind of top, on the batch's bytes (no
    view made): where the tail takes the moments form, one call of the
    fused warp; else the warp into the held intermediate, then the planar
    tail.  Each tuple as the wrappers packed it on the views that the route
    made."""
    cfg = dataclasses.replace(CFG5, **WARP_TAILS[tail])
    pre = Preprocessor(cfg, device="cpu")
    interp = pipeline._FUSED_INTERP[InterMode(cfg.interpolation)]
    batch = frames(2)
    planes = batch.permute(0, 3, 1, 2)
    minv = pre._minv
    for top in (None, 9, -3, 400, torch.tensor(4, dtype=torch.int32)):
        lib.calls.clear()
        rec = pre._prepare(batch, top)
        out = rec.run(batch, top)
        if top is None:
            view, row0, rows = planes[:, :, 3:45, 2:62], None, None
        elif isinstance(top, torch.Tensor):
            view, row0, rows = planes.narrow(3, 2, 60), top, 42
        else:
            view, row0, rows = planes[:, :, min(max(top, 0), 6):, 2:62][:, :, :42], None, None
        if tail.startswith("fused"):
            assert isinstance(rec, pipeline._FusedWarpRecord)
            want = [fused_warp_args(view, minv, 30, 40, out, 0x5EED, rec.fused.held[-1].data_ptr(),
                                    OUT, row0, rows, interp, cfg.mean, cfg.stddev)]
            assert only_calls(lib) == want, top
            continue
        warp = parent_warp_args(view, minv, 30, 40, rec.warped, 0x5EED, row0, rows)
        geom = pk._planes_geometry(rec.warped, OUT, interp)
        plan = pk._plan(geom, "planar", pk.card_limits(None), cfg.normalize, cfg.mean,
                        cfg.stddev, True)
        scratch = rec.tail.held[-1].data_ptr() if plan.form == "moments" else None
        tail_calls = parent_fused_args(rec.warped, out, geom, None, None, cfg.mean, cfg.stddev,
                                       cfg.normalize, True, interp, plan, True, 0x5EED, scratch)
        assert only_calls(lib) == [warp] + tail_calls, top


def test_a_warp_record_into_a_given_output_packs_its_arguments_as_before(lib):
    """The public warp wrapper's card path (prepare, then run) with an
    output of its own strides, written in place."""
    planes = frames(2).permute(0, 3, 1, 2)
    out = torch.empty((2, 3, 40, 30), dtype=torch.uint8).permute(0, 1, 3, 2)
    minv = np.array([[1.1, 0.02, -3.0], [0.01, 0.9, 2.0]], np.float32)
    top = torch.tensor(2, dtype=torch.int32)
    rec = warp_affine.prepare_warp_planes(planes, minv, 30, 40, row0=top, rows=40, out=out)
    assert rec.run(planes, top, out) is out
    assert only_calls(lib) == [parent_warp_args(planes, minv, 30, 40, out, 0x5EED, top, 40)]


@pytest.mark.parametrize("tail", ["fused", "two_launch_static_stats"])
@pytest.mark.parametrize("top", [None, 9, torch.tensor(4, dtype=torch.int32)])
def test_warp_records_count_the_3_channel_form(lib, top, tail):
    """Config 5's route, a record made, then hits: with the fused warp,
    one ``preprocess_fused_warp`` call a batch and no
    ``warp.hwc3_launches``; with a tail the fused warp does not serve, the
    warp and the planar tail a batch, and one ``warp.hwc3_launches`` a run
    of the warp.  None for warp calls that do not take the 3-channel HWC
    form (planar, f32, cubic)."""
    pre = Preprocessor(dataclasses.replace(CFG5, **WARP_TAILS[tail]), device="cpu")
    batch = frames(2)
    before = trace.counter("warp.hwc3_launches")
    fused = config.kernel_count("preprocess_fused_warp")
    made, hits = trace.counter("pipeline.records_made"), trace.counter("pipeline.record_hits")
    for _ in range(3):
        pre._record(batch, top).run(batch, top)
    assert trace.counter("pipeline.records_made") == made + 1
    assert trace.counter("pipeline.record_hits") == hits + 2
    one = tail == "fused"
    assert [n for n, _, _ in lib.calls] == 3 * (["vacv_preprocess_warp_moments"] if one else
                                                ["vacv_warp_affine", "vacv_preprocess_resize"])
    assert config.kernel_count("preprocess_fused_warp") == fused + 3 * one
    assert trace.counter("warp.hwc3_launches") == before + 3 * (not one)
    before = trace.counter("warp.hwc3_launches")
    hwc = batch.permute(0, 3, 1, 2)
    minv = np.array([[1.1, 0.02, -3.0], [0.01, 0.9, 2.0]], np.float32)
    for planes, kw in ((hwc.contiguous(), {}), (hwc.float(), {}),
                       (hwc, dict(interp=InterMode.INTER_CUBIC))):
        rec = warp_affine.prepare_warp_planes(planes, minv, 30, 40, **kw)
        assert not rec.hwc3
        rec.run(planes)
    assert trace.counter("warp.hwc3_launches") == before


def test_the_fused_warp_serves_only_3_channel_hwc_moments_calls(lib):
    """``prepare_fused_warp`` returns None, and the record keeps the warp
    and the planar tail, where the warp's call does not take the 3-channel
    HWC form (planar or f32 planes, an HWC view of 4 channels), where the
    tail's plan is not the moments form, and for an empty batch."""
    minv = np.array([[1.1, 0.02, -3.0], [0.01, 0.9, 2.0]], np.float32)
    hwc = frames(2).permute(0, 3, 1, 2)
    assert pk.prepare_fused_warp(hwc, minv, 30, 40, OUT) is not None
    four = torch.zeros((2, 48, 64, 4), dtype=torch.uint8).permute(0, 3, 1, 2)[:, :3]
    for planes in (hwc.contiguous(), four, hwc[:0]):
        assert pk.prepare_fused_warp(planes, minv, 30, 40, OUT) is None
    for kw in (dict(normalize=False), dict(mean=1.0, stddev=2.0)):
        assert pk.prepare_fused_warp(hwc, minv, 30, 40, OUT, **kw) is None
    with pytest.raises(ValueError):
        pk.prepare_fused_warp(hwc, minv, 30, 40, OUT, interp="area")
    with pytest.raises(ValueError):
        pk.prepare_fused_warp(hwc, minv, 30, 40, OUT, row0=torch.tensor(2), rows=99)
    assert lib.calls == []


# --- the records in the Preprocessor -----------------------------------------

def test_a_record_keeps_its_tables_and_scratch(lib):
    """The tap tables a record's arguments point at stay alive with the
    record when their cache drops them."""
    batch = frames(2)
    rec = Preprocessor(CFG4, device="cpu")._prepare(batch, None)
    pk._device_taps.cache_clear()
    ys, yw, xs, xw, scratch = rec.held
    args = rec.args
    assert (args[16], args[17], args[19], args[20]) == (ys.data_ptr(), yw.data_ptr(),
                                                       xs.data_ptr(), xw.data_ptr())
    assert args[4] == scratch.data_ptr()
    a = rec.run(batch)
    b = rec.run(batch)
    assert a.data_ptr() != b.data_ptr()  # a new output every call


def test_the_records_are_bounded(lib):
    pre = Preprocessor(CFG4, device="cpu")
    shapes = [frames(n) for n in range(1, pipeline._RECORDS + 5)]
    for batch in shapes:
        pre._record(batch, None)
    assert len(pre._records) == pipeline._RECORDS
    kept = [pipeline.launch_signature(b, None) for b in shapes[4:]]
    assert list(pre._records) == kept  # the oldest went first
    made = trace.counter("pipeline.records_made")
    pre._record(shapes[-1], None)
    assert trace.counter("pipeline.records_made") == made
    pre._record(shapes[0], None)
    assert trace.counter("pipeline.records_made") == made + 1
    assert len(pre._records) == pipeline._RECORDS


def test_the_counters_over_a_scripted_run(lib):
    """Made once a signature and stream, a hit every other time; a route
    without a record counts neither."""
    pre = Preprocessor(CFG4, device="cpu")
    a, b = frames(2), frames(3)
    made, hits = trace.counter("pipeline.records_made"), trace.counter("pipeline.record_hits")
    script = [(a, None), (frames(2, seed=4), None), (a, 5), (a, 9),
              (a, torch.tensor(3, dtype=torch.int32)), (a, torch.tensor(8, dtype=torch.int32)),
              (b, None), (a, None), (a.float(), None), (a.float(), None)]
    for arr, top in script:
        rec = pre._record(arr, top)
        if rec is not None:
            rec.run(arr, top)
    assert pre._records[pipeline.launch_signature(a.float(), None)] is None  # the chain's
    lib.stream["handle"] = 2
    for _ in range(3):
        pre._record(a, None).run(a)
    assert trace.counter("pipeline.records_made") - made == 5
    assert trace.counter("pipeline.record_hits") - hits == 6
    assert len(lib.calls) == 8 + 3


def test_a_cpu_batch_and_a_route_without_a_record_make_none(lib):
    made = trace.counter("pipeline.records_made")
    pre = Preprocessor(CFG4, device="cpu")
    pre.batch(frames(2).numpy())
    assert pre._records == {} and not lib.calls
    nv = Preprocessor(dataclasses.replace(CFG5, color_code=ColorCode.COLOR_YUV2BGR_NV21),
                      device="cpu")
    assert nv._prepare(torch.zeros((2, 72, 64), dtype=torch.uint8), None) is None
    assert trace.counter("pipeline.records_made") == made

