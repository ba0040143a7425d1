from .compare import MAX_DIFF, REF_MAX_DIFF, cosine_similarity, passes
from .perf import Timer, device_time, time_fn, time_perf
