"""align.roofline: the alignment kernel's least time a batch (each face's
f32 output and the u8 source bytes its taps can reach, 3 min(b^2, 4 x 112^2)
for a box side b, at the card's published bandwidth) over its device time
a batch, the kernel found by name in the trace's operations (``roofline``
of the configuration's chain).  Nothing when the card has no published
peak or the trace holds no such kernel."""
from portbench import manifest


def read(result):
    chain = manifest.chain(result.cfg)
    return chain.roofline(result) if hasattr(chain, "roofline") else None
