"""track.corr_roofline: the template correlation's least time a frame (its
float32 operations at the card's published f32 rate) over its device time
a frame: the profiled sub-window's device time of the operations named
``corr_kernel`` or ``split_sum_kernel`` (the sum of its channel splits),
over the frames the card ran there (``kernel_roofline`` of the
configuration's chain).  Nothing when the card has no published peak or
the trace holds no such kernel."""
from portbench import manifest


def read(result):
    return manifest.chain(result.cfg).kernel_roofline(result, "corr")
