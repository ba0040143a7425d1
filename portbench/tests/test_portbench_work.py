"""The least work of each chain, counted from shapes and geometry."""
from __future__ import annotations

import pytest

from portbench import manifest, work

BENCH = manifest.load()


def _cfg(name):
    return manifest.config(BENCH, {"config": name})


def test_config4_at_32_frames_moves_96_3_mb():
    b = work.chain_bytes(_cfg("cfg4_fused_1080p"), 32)
    # 448 tap rows of the crop, 168 sectors of 32 bytes each, and the f32 output
    assert b == 32 * (448 * 168 * 32 + 3 * 224 * 224 * 4) == 96_337_920
    assert work.least_seconds(_cfg("cfg4_fused_1080p"), 32, "NVIDIA H100 80GB HBM3") \
        == pytest.approx(28.76e-6, abs=0.01e-6)


def test_config5_counts_the_crop_the_warp_then_resize_reads():
    cfg = _cfg("cfg5_warp_1440p")
    one = work.chain_bytes(cfg, 1)
    out = 3 * 224 * 224 * 4
    crop = cfg["crop"]["width"] * cfg["crop"]["height"] * 3
    assert out < one < crop + out  # some of the crop, never the warped planes
    assert work.chain_bytes(cfg, 2) == 2 * one


def test_unknown_card_has_no_least_time():
    assert work.least_seconds(_cfg("cfg4_fused_1080p"), 32, "some other card") is None


@pytest.mark.parametrize("name,frames,want", [("cfg4_fused_1080p", 32, 96_337_920),
                                              ("cfg5_warp_1440p", 16, 55_587_840)])
def test_a_config_without_a_chain_counts_through_the_default_chain(name, frames, want):
    cfg = _cfg(name)
    assert "chain" not in cfg
    assert manifest.chain(cfg).chain_bytes(cfg, frames) == want == work.chain_bytes(cfg, frames)
    assert work.least_seconds(cfg, frames, "NVIDIA H100 80GB HBM3") == want / 3.35e12
