from .crop import crop, crop_dynamic
from .cvt_color import cvt_color
from .dtype import change_dtype
from .fused import resize_normalize, warp_affine_normalize, warp_affine_normalize_rot
from .imencode import imencode
from .layout import change_layout
from .match_template import match_template, min_max_idx, min_max_loc
from .normalize import mean_stddev, normalize
from .resize import resize
from .warp_affine import get_rotation_matrix_2d, invert_affine, warp_affine, warp_affine_rot
