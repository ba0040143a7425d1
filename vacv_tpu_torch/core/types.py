"""Core enums and geometry types for vacv_tpu_torch.

A copy of ``vacv_tpu/core/types.py``, which is pure Python: the enum
values and ``VRect.int_bounds`` truncation are the reference's own
(``vision_structs.h:6-192``, ``cv.h:11-74``), so user code passes the
same integers and rects to either package.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class Layout(enum.Enum):
    """Memory layout of an image array.

    Mirrors ``vision::VTensorLayout`` (reference ``tensor.h:21-24``).
    ``HWC`` is the interchange layout (what cv2/PIL produce); ``CHW`` is
    the planar layout a network input takes.
    """

    HWC = "HWC"
    CHW = "CHW"


class InterMode(enum.IntEnum):
    """Interpolation modes (reference ``cv.h:28-36``)."""

    INTER_NEAREST = 0
    INTER_LINEAR = 1
    INTER_CUBIC = 2
    INTER_AREA = 3
    INTER_LANCZOS4 = 4
    INTER_MAX = 7
    WARP_INVERSE_MAP = 16


class BorderMode(enum.IntEnum):
    """Border handling modes (reference ``cv.h:39-49``)."""

    BORDER_CONSTANT = 0
    BORDER_REPLICATE = 1
    BORDER_REFLECT = 2
    BORDER_WRAP = 3
    BORDER_REFLECT_101 = 4
    BORDER_TRANSPARENT = 5
    BORDER_ISOLATED = 16

    # alias matching OpenCV
    BORDER_DEFAULT = 4


class MatchMode(enum.IntEnum):
    """Template-matching modes (reference ``cv.h:52-59``)."""

    TM_SQDIFF = 0
    TM_SQDIFF_NORMED = 1
    TM_CCORR = 2
    TM_CCORR_NORMED = 3
    TM_CCOEFF = 4
    TM_CCOEFF_NORMED = 5


class ColorCode(enum.IntEnum):
    """Color-conversion codes (reference ``cv.h:62-74``).

    Values match the reference's ``InputImageFormat`` enum so user code
    can pass the same integers.
    """

    # Common channel-shuffle / gray codes (OpenCV numbering; the
    # reference serves these through cvt_color_opencv,
    # cvt_color.cpp:166-169 — here they are native).  Pairs sharing a
    # value are the same operation on untagged arrays (e.g. BGR2RGB
    # and RGB2BGR are both a channel reversal).
    COLOR_BGR2BGRA = 0
    COLOR_RGB2RGBA = 0
    COLOR_BGRA2BGR = 1
    COLOR_RGBA2RGB = 1
    COLOR_BGR2RGBA = 2
    COLOR_RGB2BGRA = 2
    COLOR_RGBA2BGR = 3
    COLOR_BGRA2RGB = 3
    COLOR_BGR2RGB = 4
    COLOR_RGB2BGR = 4
    COLOR_BGRA2RGBA = 5
    COLOR_RGBA2BGRA = 5
    COLOR_BGR2GRAY = 6
    COLOR_RGB2GRAY = 7
    COLOR_GRAY2RGB = 8
    COLOR_GRAY2BGR = 8
    COLOR_GRAY2BGRA = 9
    COLOR_GRAY2RGBA = 9
    COLOR_BGRA2GRAY = 10
    COLOR_RGBA2GRAY = 11
    COLOR_BGR2YCrCb = 36
    COLOR_RGB2YCrCb = 37
    COLOR_YCrCb2BGR = 38
    COLOR_YCrCb2RGB = 39
    COLOR_BGR2HSV = 40
    COLOR_RGB2HSV = 41
    COLOR_HSV2BGR = 54
    COLOR_HSV2RGB = 55
    COLOR_BGR2YUV = 82
    COLOR_RGB2YUV = 83
    COLOR_YUV2BGR = 84
    COLOR_YUV2RGB = 85
    COLOR_YUV2RGB_NV12 = 90
    COLOR_YUV2BGR_NV12 = 91
    COLOR_YUV2RGB_NV21 = 92
    COLOR_YUV2BGR_NV21 = 93
    COLOR_YUV2RGBA_NV12 = 94
    COLOR_YUV2BGRA_NV12 = 95
    COLOR_YUV2RGBA_NV21 = 96
    COLOR_YUV2BGRA_NV21 = 97
    COLOR_YUV2BGR_YV12 = 99


@dataclass(frozen=True)
class VSize:
    """Target size ``(w, h)`` (reference ``cv.h:11-16``)."""

    w: int
    h: int


@dataclass(frozen=True)
class VScalar:
    """Up-to-4-component scalar (reference ``cv.h:18-25``)."""

    v0: float = 0.0
    v1: float = 0.0
    v2: float = 0.0
    v3: float = 0.0


@dataclass(frozen=True)
class VPoint:
    """2-D point (reference ``vision_structs.h``)."""

    x: float = 0.0
    y: float = 0.0


@dataclass(frozen=True)
class VRect:
    """Crop rectangle ``{left, top, right, bottom}``.

    Mirrors ``vision::VRect`` (reference ``vision_structs.h:122-133``).
    Like the reference's crop dispatcher (``crop.cpp:127-131``) the
    float fields are truncated to ``int`` at use sites.
    """

    left: float = 0.0
    top: float = 0.0
    right: float = 0.0
    bottom: float = 0.0

    def width(self) -> float:
        return self.right - self.left

    def height(self) -> float:
        return self.bottom - self.top

    def int_bounds(self) -> tuple[int, int, int, int]:
        """``(left, top, width, height)`` as C-truncated ints."""
        left = int(self.left)
        top = int(self.top)
        w = int(self.width())
        h = int(self.height())
        return left, top, w, h

    def contains(self, p: VPoint) -> bool:
        return self.left <= p.x < self.right and self.top <= p.y < self.bottom


# Normalization algorithm selector (reference ``vision_structs.h:189-191``).
class NormalAlg(enum.IntEnum):
    MUL = 0
    DIV = 1


@dataclass(frozen=True)
class VPoint3:
    """3-D point (reference ``vision_structs.h`` VPoint3)."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclass(frozen=True)
class VAngle:
    """Euler-angle triple (reference ``vision_structs.h`` VAngle:
    yaw/pitch/roll, used by the face-pose callers of warp_affine)."""

    yaw: float = 0.0
    pitch: float = 0.0
    roll: float = 0.0


@dataclass(frozen=True)
class VEyeInfo:
    """Eye landmark info (reference ``vision_structs.h`` VEyeInfo) —
    carried for API parity with the reference's face-alignment callers."""

    center: VPoint = VPoint()
    angle: float = 0.0


@dataclass
class VMatrix:
    """Small dense matrix value type (reference ``vision_structs.h``
    VMatrix).  Here simply a shaped numpy array wrapper; device math
    uses torch tensors directly."""

    data: object = None

    def numpy(self):
        import numpy as np

        return np.asarray(self.data)


@dataclass(frozen=True)
class SimpleSize:
    """(w, h) pair (reference ``vision_structs.h`` SimpleSize)."""

    width: int = 0
    height: int = 0


@dataclass(frozen=True)
class ExtreSize:
    """Min/max size bound pair (reference ``vision_structs.h``
    ExtreSize)."""

    min_size: SimpleSize = SimpleSize()
    max_size: SimpleSize = SimpleSize()


@dataclass(frozen=True)
class IndexValue:
    """(index, value) pair, the minMaxIdx result element (reference
    ``vision_structs.h`` IndexValue)."""

    index: int = 0
    value: float = 0.0
