"""Frames made from ``--seed``, on the device, in a few large calls.

Every frame is uniform noise at half contrast over a vertical ramp whose
slope is drawn per frame, so the frames differ in their statistics and no
two frames of a pool are alike.
"""
from __future__ import annotations

import torch

from .stats import rng


def _generator(device, seed: int, salt: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))
    return g


def frames(cfg: dict, n: int, seed: int, salt: int, device) -> torch.Tensor:
    """(n, H, W, 3) u8 frames of ``cfg``'s shape on ``device``."""
    fr = cfg["frame"]
    h, w, c = fr["height"], fr["width"], fr["channels"]
    g = _generator(device, seed, salt)
    noise = torch.randint(0, 256, (n, h, w, c), dtype=torch.uint8, device=device, generator=g)
    slope = torch.randint(-96, 97, (n, 1, 1, 1), dtype=torch.int16, device=device, generator=g)
    ramp = (torch.arange(h, device=device, dtype=torch.int16) * 2 - h).reshape(1, h, 1, 1)
    out = noise.to(torch.int16).div_(2, rounding_mode="floor").add_(64)
    out.add_((ramp.to(torch.int32) * slope // h).to(torch.int16))
    return out.clamp_(0, 255).to(torch.uint8)


def tops(cfg: dict, count: int, seed: int, salt: int) -> list[int]:
    """``count`` crop tops drawn from [0, H - crop height]."""
    hi = cfg["frame"]["height"] - cfg["crop"]["height"]
    return [int(t) for t in rng(seed, 5, salt).integers(0, hi + 1, size=count)]
