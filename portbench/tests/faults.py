"""Faults planted under the program for the fault tests: each breaks what
the timed path produces in one way the cells can have.  ``plant`` patches
``systems.Program`` in this process; ``plant_rank`` plants a fault of a
per-card run in one rank's process."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from portbench import systems

FAULTS = ("stale", "half_batch", "altered")
RANK_FAULTS = ("exchange", "rank_exits")
EXIT_AT_STEP = 40  # a step of the window of a short run (the warm-up takes 17)


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
    batch, frame, sharded = systems.Program.batch, systems.Program.frame, systems.Program.sharded
    systems.Program.batch = lambda self, f, top: _break(batch(self, f, top), fault, memo)
    systems.Program.frame = lambda self, f: _break(frame(self, f)[None], fault, memo)[0]

    def broken_sharded(self, mesh):
        step = sharded(self, mesh)
        return lambda f, top: _break(step(f, top), fault, memo)

    systems.Program.sharded = broken_sharded


def plant_rank(fault: str, rank: int) -> None:
    """``exchange``: the exchange between the ranks left out (every
    ``all_reduce`` returns at once, the tensor as it was).  ``rank_exits``:
    every rank but 0 exits with code 3 at a step inside the window."""
    if fault == "exchange":
        dist.all_reduce = lambda tensor, *args, **kwargs: None
    elif fault == "rank_exits" and rank > 0:
        sharded = systems.Program.sharded

        def exiting(self, mesh):
            step, calls = sharded(self, mesh), [0]

            def run(frames, top):
                calls[0] += 1
                if calls[0] == EXIT_AT_STEP:
                    os._exit(3)
                return step(frames, top)
            return run

        systems.Program.sharded = exiting
