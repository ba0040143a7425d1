"""The ``Image`` container: a ``torch.Tensor`` plus its layout.

The counterpart of ``vacv_tpu/core/image.py``.  PyTorch runs eagerly,
so there is no pytree: ``Image`` is a frozen dataclass of (tensor,
layout).  The layout/dtype conversions live in ``ops/layout.py`` and
``ops/dtype.py`` and are exposed here as methods for parity with the
reference's ``Tensor::change_layout`` / ``Tensor::change_dtype``
(``tensor.cpp:393-502``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .types import Layout


@dataclass(frozen=True)
class Image:
    """A single image: ``data`` plus its layout.

    ``data`` is an HWC or CHW tensor (2-D tensors are treated as single
    channel).  Ops run on the device ``data`` lies on.
    """

    data: torch.Tensor
    layout: Layout = Layout.HWC

    # -- shape accessors (mirror Tensor fields w,h,c — tensor.h:71-78) ---
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def h(self) -> int:
        if self.data.ndim == 2:
            return self.data.shape[0]
        return self.data.shape[0] if self.layout == Layout.HWC else self.data.shape[1]

    @property
    def w(self) -> int:
        if self.data.ndim == 2:
            return self.data.shape[1]
        return self.data.shape[1] if self.layout == Layout.HWC else self.data.shape[2]

    @property
    def c(self) -> int:
        if self.data.ndim == 2:
            return 1
        return self.data.shape[2] if self.layout == Layout.HWC else self.data.shape[0]

    # -- conversions -----------------------------------------------------
    def with_data(self, data) -> "Image":
        return replace(self, data=data)

    def change_layout(self, layout: Layout) -> "Image":
        """HWC↔CHW transpose (parity: ``Tensor::change_layout``,
        reference ``tensor.cpp:393-457``)."""
        from ..ops.layout import change_layout

        return change_layout(self, layout)

    def change_dtype(self, dtype) -> "Image":
        """u8↔float conversion (parity: ``Tensor::change_dtype``,
        reference ``tensor.cpp:459-502``)."""
        from ..ops.dtype import change_dtype

        return change_dtype(self, dtype)

    def numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is, or a numpy array / sequence as a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def as_image(x, layout: Layout = Layout.HWC) -> Image:
    """Coerce a tensor / array / Image to an ``Image``."""
    if isinstance(x, Image):
        return x
    return Image(as_tensor(x), layout)


def as_array(x):
    """Coerce a tensor / Image to its raw tensor."""
    return x.data if isinstance(x, Image) else x
