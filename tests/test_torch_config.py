"""``VACV_BACKEND`` in the port: read once at import, as ``vacv_tpu.config``
reads it, and mapped onto the port's two backends (``jnp`` or ``torch`` →
``"torch"``; ``auto``, ``pallas`` or unset → ``"auto"``; anything else
raises).  With ``"torch"`` the ops take their plain PyTorch chain, as the
JAX package's ops take their jnp route under ``VACV_BACKEND=jnp``."""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import vacv_tpu_torch as vt
from vacv_tpu_torch import config
from vacv_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def reloaded(monkeypatch):
    """Reload ``config`` under a given VACV_BACKEND; put the module back as
    it was (backend, default device, counters) afterwards."""
    state = (config._BACKEND, config._DEVICE, trace.snapshot()["counters"])

    def go(value):
        if value is None:
            monkeypatch.delenv("VACV_BACKEND", raising=False)
        else:
            monkeypatch.setenv("VACV_BACKEND", value)
        return importlib.reload(config)

    yield go
    monkeypatch.delenv("VACV_BACKEND", raising=False)
    importlib.reload(config)
    config._BACKEND, config._DEVICE = state[0], state[1]
    for name, n in state[2].items():
        trace.count(name, n - trace.counter(name))


@pytest.mark.parametrize("value,want", [
    (None, "auto"), ("auto", "auto"), ("pallas", "auto"), ("jnp", "torch"), ("torch", "torch"),
])
def test_vacv_backend_maps_onto_the_ports_backends(reloaded, value, want):
    mod = reloaded(value)
    assert mod is config and config.get_backend() == want
    assert config.use_fused() == (want == "auto")


@pytest.mark.parametrize("value", ["cuda", "JNP", ""])
def test_unknown_vacv_backend_raises_at_import(reloaded, value):
    with pytest.raises(ValueError, match="VACV_BACKEND"):
        reloaded(value)


def test_jnp_backend_takes_the_plain_chain(reloaded):
    """Under VACV_BACKEND=jnp a CHW f32 normalize does not go to the
    kernel's wrapper (neither counter rises)."""
    reloaded("jnp")
    names = ("normalize_fused_torch", "normalize_fused")
    before = [config.kernel_count(n) for n in names]
    x = np.random.default_rng(0).random((3, 8, 8), dtype=np.float32)
    with config.device("cpu"):
        vt.normalize(vt.Image(vt.core.image.as_tensor(x), vt.CHW))
    assert [config.kernel_count(n) for n in names] == before


def test_vacv_backend_in_a_fresh_interpreter():
    code = "import vacv_tpu_torch as vt; print(vt.config.get_backend())"

    def run(value):
        return subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=120,
                              capture_output=True, text=True,
                              env={**os.environ, "VACV_BACKEND": value})

    assert run("jnp").stdout.strip() == "torch"
    bad = run("mosaic")
    assert bad.returncode != 0 and "VACV_BACKEND" in bad.stderr
