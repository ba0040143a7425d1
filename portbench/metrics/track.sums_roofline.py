"""track.sums_roofline: the window sums' least time a frame (the f32 planes
read once and the four sum maps written once, at the card's published
bandwidth) over their device time a frame: the profiled sub-window's
device time of the operations named ``window_sum_kernel``, over the frames
the card ran there (``kernel_roofline`` of the configuration's chain).
Nothing when the card has no published peak or the trace holds no such
kernel."""
from portbench import manifest


def read(result):
    return manifest.chain(result.cfg).kernel_roofline(result, "sums")
