"""vacv_tpu_torch core against vacv_tpu: types, Image, layout, dtype, crop.

The same numpy inputs go through the JAX package (the reference) and the
PyTorch port; structural ops must agree bit for bit.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vacv_tpu as vc
import vacv_tpu_torch as vt
from vacv_tpu.core import types as jtypes
from vacv_tpu.ops.crop import crop_dynamic as j_crop_dynamic
from vacv_tpu.utils import compare as jcompare
from vacv_tpu_torch.core import types as ttypes
from vacv_tpu_torch.ops.crop import crop_dynamic as t_crop_dynamic
from vacv_tpu_torch.utils import compare as tcompare
from vacv_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port puts numpy inputs on the card by default; these tests ask
    for the CPU."""
    with config.device("cpu"):
        yield


ENUMS = ["Layout", "InterMode", "BorderMode", "MatchMode", "ColorCode", "NormalAlg"]


@pytest.mark.parametrize("name", ENUMS)
def test_enum_values_match(name):
    j, t = getattr(jtypes, name), getattr(ttypes, name)
    assert [(m.name, m.value) for m in j] == [(m.name, m.value) for m in t]
    # aliases (e.g. BORDER_DEFAULT, the paired cvt codes) too
    assert {k: v.value for k, v in j.__members__.items()} == {
        k: v.value for k, v in t.__members__.items()
    }


@pytest.mark.parametrize("rect", [
    (0, 0, 10, 10), (1.9, 2.7, 30.2, 40.99), (-3.5, -0.5, 7.25, 8.75),
    (64, 28, 1856, 1064), (0.5, 0.5, 0.9, 0.9),
])
def test_vrect_int_bounds_truncation(rect):
    j, t = jtypes.VRect(*rect), ttypes.VRect(*rect)
    assert j.int_bounds() == t.int_bounds()
    assert (j.width(), j.height()) == (t.width(), t.height())
    p = jtypes.VPoint(2.0, 3.0)
    assert j.contains(p) == t.contains(ttypes.VPoint(2.0, 3.0))


def test_image_accessors():
    a = np.zeros((5, 7, 3), np.uint8)
    for layout, data in [(vt.HWC, a), (vt.CHW, a.transpose(2, 0, 1))]:
        j = vc.Image(jnp.asarray(data), vc.Layout(layout.value))
        t = vt.Image(torch.from_numpy(np.ascontiguousarray(data)), layout)
        assert (j.h, j.w, j.c) == (t.h, t.w, t.c) == (5, 7, 3)
    g = vt.as_image(np.zeros((4, 6), np.float32))
    assert (g.h, g.w, g.c) == (4, 6, 1) and g.layout == vt.HWC


@pytest.mark.parametrize("shape,src,dst", [
    ((6, 9, 3), "HWC", "CHW"), ((3, 6, 9), "CHW", "HWC"),
    ((6, 9, 3), "HWC", "HWC"), ((6, 9), "HWC", "CHW"),
])
def test_change_layout_matches(shape, src, dst):
    a = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    j = vc.Image(jnp.asarray(a), vc.Layout(src)).change_layout(vc.Layout(dst))
    t = vt.Image(torch.from_numpy(a), vt.Layout(src)).change_layout(vt.Layout(dst))
    assert t.layout == vt.Layout(dst)
    assert t.data.is_contiguous()
    np.testing.assert_array_equal(np.asarray(j.data), t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "float64"])
def test_change_dtype_u8_to_float(dtype):
    a = np.random.default_rng(1).integers(0, 256, (5, 6, 3), dtype=np.uint8)
    j = vc.change_dtype(a, dtype)
    t = vt.change_dtype(a, dtype)
    assert t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        np.asarray(j.data.astype(jnp.float32)), t.data.to(torch.float32).numpy()
    )


def test_change_dtype_float_to_u8_truncates_and_saturates():
    vals = np.array([-300.0, -1.5, -0.5, 0.0, 0.49, 0.5, 0.99, 1.0, 127.9,
                     254.5, 255.0, 255.7, 256.0, 1e6, 3e9], np.float32)
    a = np.stack([vals, vals[::-1], vals * 0.5], axis=-1)[None]
    j = np.asarray(vc.change_dtype(a, "uint8").data)
    t = vt.change_dtype(a, torch.uint8).numpy()
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(t[0, :4, 0], [0, 0, 0, 0])
    assert t[0, 8, 0] == 127 and t[0, 11, 0] == 255


def test_change_dtype_rejects_int_targets():
    with pytest.raises(NotImplementedError):
        vt.change_dtype(np.zeros((2, 2, 3), np.float32), torch.int32)


@pytest.mark.parametrize("rect", [
    (10, 5, 50, 45), (0.9, 1.9, 33.3, 20.7), (0, 0, 64, 48), (60, 40, 64, 48),
])
@pytest.mark.parametrize("layout", ["HWC", "CHW"])
def test_crop_matches(rect, layout):
    a = np.random.default_rng(2).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    if layout == "CHW":
        a = np.ascontiguousarray(a.transpose(2, 0, 1))
    j = vc.crop(vc.Image(jnp.asarray(a), vc.Layout(layout)), vc.VRect(*rect))
    t = vt.crop(vt.Image(torch.from_numpy(a), vt.Layout(layout)), vt.VRect(*rect))
    np.testing.assert_array_equal(np.asarray(j.data), t.numpy())


def test_crop_rejects_empty_rect():
    with pytest.raises(ValueError):
        vt.crop(np.zeros((8, 8, 3), np.uint8), vt.VRect(4, 4, 4, 6))


@pytest.mark.parametrize("left,top", [(3, 7), (0, 0), (-5, -2), (30, 40), (100, 100)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_crop_dynamic_matches_dynamic_slice(left, top, as_tensor):
    """Int or 0-d tensor offsets, clamped like lax.dynamic_slice."""
    a = np.random.default_rng(3).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    j = j_crop_dynamic(vc.Image(jnp.asarray(a)), left, top, 20, 16)
    if as_tensor:
        left, top = torch.tensor(left), torch.tensor(top, dtype=torch.int32)
    t = t_crop_dynamic(vt.Image(torch.from_numpy(a)), left, top, 20, 16)
    np.testing.assert_array_equal(np.asarray(j.data), t.numpy())


def test_crop_dynamic_planar_and_gray():
    a = np.random.default_rng(4).integers(0, 256, (3, 30, 40), dtype=np.uint8)
    j = j_crop_dynamic(vc.Image(jnp.asarray(a), vc.CHW), 5, 6, 10, 12)
    t = t_crop_dynamic(vt.Image(torch.from_numpy(a), vt.CHW), 5, torch.tensor(6), 10, 12)
    np.testing.assert_array_equal(np.asarray(j.data), t.numpy())
    g = a[0]
    j = j_crop_dynamic(vc.Image(jnp.asarray(g)), 35, 2, 10, 12)
    t = t_crop_dynamic(vt.Image(torch.from_numpy(g)), 35, 2, 10, 12)
    np.testing.assert_array_equal(np.asarray(j.data), t.numpy())


def test_compare_module_matches():
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(3, 9, 9)), rng.normal(size=(3, 9, 9))
    assert tcompare.cosine_similarity(a, b) == jcompare.cosine_similarity(a, b)
    assert (tcompare.MAX_DIFF, tcompare.REF_MAX_DIFF) == (
        jcompare.MAX_DIFF, jcompare.REF_MAX_DIFF)
    assert tcompare.passes(1 - 5e-5) and not tcompare.passes(1 - 2e-4)


def test_config_backend_and_counters():
    from vacv_tpu_torch import config

    assert config.get_backend() == "auto" and config.use_fused()
    with config.backend("torch"):
        assert not config.use_fused()
    assert config.use_fused()
    with pytest.raises(ValueError):
        config.set_backend("pallas")
    before = config.kernel_count("test_counter")
    config.record_kernel("test_counter")
    assert config.kernel_count("test_counter") == before + 1


def test_import_loads_neither_jax_nor_triton():
    """The port must import on a host with no jax, triton, nvcc or GPU."""
    code = (
        "import sys, vacv_tpu_torch, vacv_tpu_torch.models, "
        "vacv_tpu_torch.ops.cuda, vacv_tpu_torch.ops.cuda.yuv2bgr, "
        "vacv_tpu_torch.ops.cuda.normalize, vacv_tpu_torch.ops.cvt_color, "
        "vacv_tpu_torch.ops.cuda.warp_affine, vacv_tpu_torch.ops.cuda.match_template, "
        "vacv_tpu_torch.ops.fused, vacv_tpu_torch.utils, vacv_tpu_torch.utils.perf, "
        "vacv_tpu_torch.utils.trace, "
        "vacv_tpu_torch.utils.io, vacv_tpu_torch.utils.loader, vacv_tpu_torch.native, "
        "vacv_tpu_torch.ops.imencode, vacv_tpu_torch.ops.cuda.probe, "
        "vacv_tpu_torch.profile, vacv_tpu_torch.profile.runner, "
        "vacv_tpu_torch.profile.probe_i8, vacv_tpu_torch.parallel, "
        "vacv_tpu_torch.parallel.mesh, vacv_tpu_torch.parallel.pipeline, "
        "vacv_tpu_torch.models.serving, vacv_tpu_torch.entry, vacv_tpu_torch.examples, "
        "vacv_tpu_torch.examples.camera_tracking, vacv_tpu_torch.examples.slam_frontend; "
        "bad = [m for m in ('jax', 'triton', 'vacv_tpu', 'benchmarks') if m in sys.modules]; "
        "assert not bad, bad"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


def test_ctypes_signatures_match_the_c_entry_points(monkeypatch):
    """The one entry table (``build.ENTRIES``) declares every C entry point
    of the library once, with its result and argument types exactly (a
    miscounted argtypes list only shows on the card otherwise), and no other
    module of the port declares one."""
    import ast
    import ctypes
    import re
    import types

    from vacv_tpu_torch.ops.cuda import build

    c_types = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong,
               "void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
               "const char*": ctypes.c_char_p}
    declared = {}
    for src in sorted(build.SRC_DIR.glob("*.cu")):
        text = src.read_text()
        if 'extern "C" {' not in text:
            continue  # kernels only (warp_affine_f32.cu): its interface is in another source
        block = text.split('extern "C" {', 1)[1]
        for result, name, params in re.findall(r"^(int|const char\*) (vacv_\w+)\(([^)]*)\)",
                                               block, re.M):
            assert name not in declared, f"{name} defined twice"
            params = [" ".join(p.split()[:-1]) for p in params.split(",") if p.strip() != "void"]
            declared[name] = (c_types[result], [c_types[p] for p in params if p])

    class Fn:
        def __call__(self):
            return 4096

    fake = types.SimpleNamespace(**{name: Fn() for name in declared})
    monkeypatch.setattr(build, "library", lambda: types.SimpleNamespace(lib=fake))
    build.entry.cache_clear()
    try:
        for name in build.ENTRIES:
            build.entry(name)
    finally:
        build.entry.cache_clear()
    assert set(build.ENTRIES) == set(declared)
    for name, (result, argtypes) in declared.items():
        fn = getattr(fake, name)
        assert (fn.restype, list(fn.argtypes)) == (result, argtypes), name
    # the table's literal names each entry once, and no other wrapper declares one
    tree = ast.parse(Path(build.__file__).read_text())
    (table,) = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "ENTRIES" for t in n.targets)]
    keys = [k.value for k in table.keys]
    assert sorted(keys) == sorted(set(keys)) == sorted(declared)
    for path in Path(build.__file__).parent.glob("*.py"):
        if path.name != "build.py":
            assert not re.search(r"\.(argtypes|restype)\b", path.read_text()), path


def assert_c_struct(source: str, struct: str, ctypes_struct) -> None:
    """``ctypes_struct`` lays out ``struct`` of ``csrc/<source>`` field for
    field: the same names, types and array lengths in the same order, so
    the same offsets."""
    import ctypes
    import re

    from vacv_tpu_torch.ops.cuda import build

    c_types = {"void*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
               "const float*": ctypes.c_void_p, "long long": ctypes.c_longlong,
               "int": ctypes.c_int, "float": ctypes.c_float}
    text = (build.SRC_DIR / source).read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        ctype, names = re.match(r"(.*?)\s*(\w+(?:\[\d+\])?(?:\s*,\s*\w+(?:\[\d+\])?)*)$",
                                decl).groups()
        for name in names.split(","):
            name, count = re.match(r"(\w+)(?:\[(\d+)\])?$", name.strip()).groups()
            t = c_types[ctype]
            fields.append((name, t * int(count) if count else t))
    assert [(n, getattr(t, "_length_", 0), getattr(t, "_type_", t)) for n, t in fields] == \
        [(n, getattr(t, "_length_", 0), getattr(t, "_type_", t)) for n, t in
         ctypes_struct._fields_]


def test_the_fused_warps_fixed_arguments_are_the_c_struct():
    """``_WarpMomentsArgs`` lays out ``WarpMomentsArgs`` of
    ``csrc/preprocess_warp.cu`` field for field."""
    from vacv_tpu_torch.ops.cuda.preprocess import _WarpMomentsArgs

    assert_c_struct("preprocess_warp.cu", "WarpMomentsArgs", _WarpMomentsArgs)


def test_the_alignments_fixed_arguments_are_the_c_struct():
    """``_AlignArgs`` lays out ``AlignArgs`` of ``csrc/align.cu`` field for
    field."""
    from vacv_tpu_torch.ops.cuda.align import _AlignArgs

    assert_c_struct("align.cu", "AlignArgs", _AlignArgs)


# ---- the default device: the card unless the caller asks for the CPU ----

def test_numpy_input_lands_on_the_default_device():
    from vacv_tpu_torch import config
    from vacv_tpu_torch.core.image import as_tensor

    a = np.zeros((4, 6, 3), np.uint8)
    assert config.default_device() == "cpu"  # this file's fixture asked for it
    assert as_tensor(a).device.type == "cpu"
    assert vt.as_image(a).data.device.type == "cpu"
    t = torch.zeros(2)
    assert as_tensor(t) is t  # a tensor stays where it lies
    with config.device("cuda"):
        assert config.default_device() == "cuda"
        assert as_tensor(t) is t
        with config.device("cpu"):
            assert vt.normalize(a.astype(np.float32)).data.device.type == "cpu"
    with pytest.raises(ValueError):
        config.set_default_device("tpu")


def test_without_a_card_the_default_raises(monkeypatch):
    """No card and no request for the CPU: a clear RuntimeError naming
    config.device("cpu"), never a quiet CPU run."""
    from vacv_tpu_torch import config
    from vacv_tpu_torch.models import PreprocessConfig, Preprocessor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.zeros((8, 10, 3), np.uint8)
    with config.device("cuda"):
        for call in (lambda: vt.normalize(a), lambda: vt.cvt_color(a, vt.COLOR_BGR2RGB),
                     lambda: vt.resize(a, (4, 4)),
                     lambda: Preprocessor(PreprocessConfig(out_size=(4, 4))).batch(a[None])):
            with pytest.raises(RuntimeError, match=r'config\.device\("cpu"\)'):
                call()
        pre = Preprocessor(PreprocessConfig(out_size=(4, 4)))
        assert pre.device.type == "cuda"
        assert pre.describe_route((8, 10, 3)) == "cuda_fused"
    # Asked for explicitly, the CPU runs.
    assert Preprocessor(PreprocessConfig(out_size=(4, 4)), device="cpu").batch(
        a[None]).device.type == "cpu"


def test_input_device_takes_the_card_when_there_is_one(monkeypatch):
    from vacv_tpu_torch import config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with config.device("cuda"):
        assert config.input_device() == torch.device("cuda")
    assert config.input_device("cuda:0") == torch.device("cuda", 0)
    assert config.input_device() == torch.device("cpu")


def test_facade_has_every_name_of_the_jax_package():
    missing = [n for n in vc.__all__ if not hasattr(vt, n)]
    assert not missing
    assert sorted(vc.__all__) == sorted(vt.__all__)
    consts = [n for n in dir(vc) if n.split("_")[0] in ("COLOR", "INTER", "BORDER", "TM", "WARP")]
    assert len(consts) == 36
    for n in consts:
        assert int(getattr(vt, n)) == int(getattr(vc, n)), n
    for n in ("VPoint3", "VAngle", "VEyeInfo", "SimpleSize", "ExtreSize", "IndexValue"):
        assert [f for f in getattr(vt, n).__dataclass_fields__] == [
            f for f in getattr(vc, n).__dataclass_fields__]


def test_port_has_the_names_of_the_parallel_and_model_layers():
    """Every public name of vacv_tpu.parallel and vacv_tpu.models (with the
    serving layer), the Preprocessor's batch and sharded entry points, and
    the entry points of __graft_entry__ exist in the port."""
    import inspect

    import __graft_entry__ as jentry
    import vacv_tpu.models as jmodels
    import vacv_tpu.parallel as jparallel
    import vacv_tpu_torch.entry as tentry
    import vacv_tpu_torch.models as tmodels
    import vacv_tpu_torch.parallel as tparallel

    for jmod, tmod in ((jparallel, tparallel), (jmodels, tmodels)):
        names = [n for n in dir(jmod) if not n.startswith("_")
                 and not inspect.ismodule(getattr(jmod, n))]
        assert names
        missing = [n for n in names if not hasattr(tmod, n)]
        assert not missing, (jmod.__name__, missing)
    for name in ("fn", "batch_fn", "batched", "batch", "__call__"):
        assert hasattr(tmodels.Preprocessor, name), name
    for name in ("entry", "dryrun_multichip"):
        assert callable(getattr(jentry, name)) and callable(getattr(tentry, name)), name
