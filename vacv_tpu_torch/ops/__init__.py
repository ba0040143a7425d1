from .crop import crop, crop_dynamic
from .dtype import change_dtype
from .layout import change_layout
from .normalize import mean_stddev, normalize
from .resize import resize
