"""The comparison that decides ``correct``.

Every output a run kept (positions drawn from the seed, and the window's
last) is compared with the plain reference (``reference.py``, float64) of
the same input, after the window has closed and the program's state has
been freed.  Numbers, each against the configuration's limit:

* ``max_err_lsb``: the largest gap between an output value and the
  reference's, in steps of the u8 grid the chain truncates to: the gap
  times the plane's ``std + 1e-6``.
* ``off_share``: the share of output values more than half a step away.

A value that is not finite counts as infinitely far.  A run with a failed
frame, or with no output kept, is not correct.
"""
from __future__ import annotations

import math

import torch

from . import reference

BLOCK = 8  # frames the reference takes at a time


class Tally:
    def __init__(self):
        self.max_err = 0.0
        self.off = 0
        self.count = 0

    def add(self, out: torch.Tensor, ref: torch.Tensor, std: torch.Tensor) -> None:
        err = (out.to(torch.float64) - ref).abs() * (std + reference.NORM_EPS)[..., None, None]
        err = torch.where(torch.isfinite(err), err, math.inf)
        self.max_err = max(self.max_err, float(err.max()))
        self.off += int((err > 0.5).sum())
        self.count += err.numel()

    def numbers(self) -> dict:
        return {"max_err_lsb": self.max_err,
                "off_share": self.off / self.count if self.count else math.inf}


def reference_of(frames: torch.Tensor, cfg: dict, top) -> tuple[torch.Tensor, torch.Tensor]:
    """(output, std) of the reference over ``frames``, BLOCK frames at a time."""
    top = cfg["crop"]["top"] if top is None else int(top)
    outs, stds = [], []
    for i in range(0, frames.shape[0], BLOCK):
        o, s = reference.chain(frames[i:i + BLOCK], cfg, top)
        outs.append(o)
        stds.append(s)
    return torch.cat(outs), torch.cat(stds)


def frames_of(pool, key, device) -> torch.Tensor:
    """The (N, H, W, 3) input of a kept output: a batch of the pool, or one
    host frame of a served pool."""
    item = pool[key]
    if isinstance(item, torch.Tensor):
        return item
    return torch.from_numpy(item).to(device)[None]


def compare(samples, pool, cfg: dict, device) -> dict:
    """The numbers over every kept (key, output) pair."""
    tally = Tally()
    for (key, top), out in samples:
        ref, std = reference_of(frames_of(pool, key, device), cfg, top)
        tally.add(out.reshape(ref.shape), ref, std)
    return tally.numbers()


def verdict(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) of the numbers compared."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                             for c in checks.values())
    return ok, checks
