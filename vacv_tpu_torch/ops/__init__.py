from .crop import crop, crop_dynamic
from .cvt_color import cvt_color
from .dtype import change_dtype
from .layout import change_layout
from .normalize import mean_stddev, normalize
from .resize import resize
