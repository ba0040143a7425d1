"""The system a cell drives: the program, or the control in its place.

``program`` is ``vacv_tpu_torch``'s ``Preprocessor`` built as the
configuration states it; it is the only thing the benchmark takes from the
port.  ``control`` is the plain reference computed in bfloat16, the
precision below the configuration's float32: ``calibrate.py`` puts it in the
program's place to show that the check fails it.
"""
from __future__ import annotations

import torch

from . import reference

# The route a configuration names, and its plain form on a CPU tensor.
CPU_ROUTES = {"cuda_fused": "fused_torch", "cuda_warp": "warp_torch"}


class Program:
    def __init__(self, cfg: dict, device):
        from vacv_tpu_torch.core.types import InterMode, Layout, VRect
        from vacv_tpu_torch.models import PreprocessConfig, Preprocessor

        c, out, wp = cfg["crop"], cfg["out"], cfg.get("warp")
        warp = None
        if wp:
            warp = (tuple(tuple(float(v) for v in row) for row in wp["matrix"]),
                    (wp["width"], wp["height"]))
        self.pre = Preprocessor(PreprocessConfig(
            crop_rect=VRect(c["left"], c["top"], c["left"] + c["width"], c["top"] + c["height"]),
            warp=warp, out_size=(out["width"], out["height"]),
            interpolation=InterMode.INTER_LINEAR, out_layout=Layout.CHW, normalize=True,
        ), device=device)
        self.cfg = cfg

    def check_route(self, frames: torch.Tensor) -> None:
        """Raise unless frames like these take the configuration's route."""
        route = self.pre.describe_route(frames.shape[1:], frames.dtype, frames.device)
        want = self.cfg["route"]
        if frames.device.type == "cpu":
            want = CPU_ROUTES[want]
        if route != want:
            raise RuntimeError(f"the program takes route {route!r}, the configuration states {want!r}")

    def batch(self, frames, top):
        return self.pre.batch(frames, top=top)

    def frame(self, frame):
        return self.pre(frame)


class Control:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg

    def check_route(self, frames) -> None:
        pass

    def batch(self, frames, top):
        top = int(top) if top is not None else self.cfg["crop"]["top"]
        return reference.chain(frames, self.cfg, top, dtype=torch.bfloat16)[0].float()

    def frame(self, frame):
        return self.batch(frame[None], None)[0]


SYSTEMS = {"program": Program, "control": Control}


def build(name: str, cfg: dict, device):
    return SYSTEMS[name](cfg, device)
