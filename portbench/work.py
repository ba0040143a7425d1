"""The least work of a chain: bytes that any implementation has to move.

A chain's bytes are the 32-byte sectors of its input that the output
depends on, each read once, plus the output written once.  They follow from
the configuration's shapes and geometry alone, so the count stays the same
however the program splits the chain into kernels; an intermediate (config
5's warped planes) is not counted.  The least time is those bytes over the
card's published memory bandwidth (``peaks.json``).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import reference

SECTOR = 32
PEAKS = Path(__file__).with_name("peaks.json")


def _sectors(rows: np.ndarray, cols: np.ndarray, row_bytes: int, pixel_bytes: int) -> int:
    """Distinct 32-byte sectors of a frame (based on a 32-byte boundary) that
    hold the pixels (rows[k], cols[k]), every channel byte of each."""
    base = rows.astype(np.int64) * row_bytes + cols.astype(np.int64) * pixel_bytes
    first, last = base // SECTOR, (base + pixel_bytes - 1) // SECTOR
    return int(np.unique(np.concatenate([first, last])).size)


def _warp_sources(cfg: dict, out_rows: np.ndarray, out_cols: np.ndarray):
    """(rows, cols) in the crop of the taps that the warped pixels
    (out_rows x out_cols) read with a weight other than 0 inside the crop."""
    wp, crop = cfg["warp"], cfg["crop"]
    h, w = crop["height"], crop["width"]
    minv = reference.invert_affine(wp["matrix"])
    sx, sy, wx0, wx1, wy0, wy1 = (t.numpy() for t in reference.warp_grid(
        minv, wp["height"], wp["width"], "cpu"))
    pick = np.ix_(out_rows, out_cols)
    rows, cols = [], []
    for dx, wx in ((0, wx0), (1, wx1)):
        for dy, wy in ((0, wy0), (1, wy1)):
            tx, ty = sx[pick] + dx, sy[pick] + dy
            keep = (wx[pick] * wy[pick] != 0) & (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            rows.append(ty[keep])
            cols.append(tx[keep])
    return np.concatenate(rows), np.concatenate(cols)


def chain_bytes(cfg: dict, frames: int) -> int:
    """Bytes of the chain of ``cfg`` over a batch of ``frames`` frames: the
    input sectors the output depends on plus the f32 output."""
    fr, crop, out = cfg["frame"], cfg["crop"], cfg["out"]
    pixel = fr["channels"]
    row_bytes = fr["width"] * pixel
    if cfg.get("warp"):
        wp = cfg["warp"]
        r, c = _warp_sources(cfg, reference.needed(wp["height"], out["height"]),
                             reference.needed(wp["width"], out["width"]))
    else:
        r, c = np.meshgrid(reference.needed(crop["height"], out["height"]),
                           reference.needed(crop["width"], out["width"]), indexing="ij")
        r, c = r.reshape(-1), c.reshape(-1)
    # The crop's top moves by whole rows; a row of the frames here is a
    # whole number of sectors, so the config's own top stands for any.
    sectors = _sectors(r + crop["top"], c + crop["left"], row_bytes, pixel)
    return frames * (sectors * SECTOR + pixel * out["height"] * out["width"] * 4)


def peak_bytes_per_s(kind: str) -> float | None:
    """The published memory bandwidth of the card named ``kind``, or None."""
    peaks = json.loads(PEAKS.read_text())["cards"]
    return peaks[kind]["hbm_bytes_per_s"] if kind in peaks else None


def least_seconds(cfg: dict, frames: int, kind: str) -> float | None:
    """The least time of ``frames`` inputs of the configuration's chain
    (its ``chain_bytes``) on the card named ``kind``, or None."""
    from . import manifest

    bw = peak_bytes_per_s(kind)
    return None if bw is None else manifest.chain(cfg).chain_bytes(cfg, frames) / bw

