from .image import Image, as_array, as_image, as_tensor
from .types import (BorderMode, ColorCode, ExtreSize, IndexValue, InterMode,
                    Layout, MatchMode, NormalAlg, SimpleSize, VAngle,
                    VEyeInfo, VMatrix, VPoint, VPoint3, VRect, VScalar, VSize)
