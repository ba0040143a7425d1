"""track.nv_roofline: the fused NV kernel's least time a frame (the
window's NV21 bytes read once and the network input written once, at the
card's published bandwidth) over its device time a frame: the profiled
sub-window's device time of the operations named ``nv_one_pass_kernel``,
over the frames the card ran there (``kernel_roofline`` of the
configuration's chain).  Nothing when the card has no published peak or
the trace holds no such kernel."""
from portbench import manifest


def read(result):
    return manifest.chain(result.cfg).kernel_roofline(result, "nv")
