"""Faults planted under the program for the fault tests: each breaks what
the timed path produces in one way the cells can have.  ``plant`` patches
``systems.Program`` in this process."""
from __future__ import annotations

import torch

from portbench import systems

FAULTS = ("stale", "half_batch", "altered")


def _break(out: torch.Tensor, fault: str, memo: dict) -> torch.Tensor:
    if fault == "stale":  # a step that returns its state unchanged
        prev = memo.get("prev")
        memo["prev"] = out
        return prev if prev is not None and prev.shape == out.shape else out
    if fault == "half_batch":  # half of the batch left out
        out = out.clone()
        n = out.shape[0]
        if n > 1:
            out[n // 2:] = 0
        else:
            out[:, :, out.shape[2] // 2:] = 0
        return out
    if fault == "altered":  # one answer altered where it is produced
        out = out.clone()
        out.view(-1)[out.numel() // 3] += 3.0
        return out
    return out


def plant(fault: str) -> None:
    memo: dict = {}
    batch, frame = systems.Program.batch, systems.Program.frame
    systems.Program.batch = lambda self, f, top: _break(batch(self, f, top), fault, memo)
    systems.Program.frame = lambda self, f: _break(frame(self, f)[None], fault, memo)[0]
