"""sort.k1_roofline: the share of its roofline at which K1
(``sort_tiles_kernel``) ran.  The least time is the bytes its launches need
for their real elements (``ops.sort.sort_tiles.bytes``: the carried keys
read once, the tuple written once; padding not counted) over the card's
memory rate; the time taken is the device time of K1's events in the
window.  Device trace.  A program without the counter reads nothing."""

from archon_tpu_torch.ops import sort as _sort
from portbench import spans

spans.install()
COUNTERS = ("archon_tpu_torch.ops.sort:sort_tiles.bytes",) if hasattr(_sort.sort_tiles, "bytes") else ()


def read(w):
    return spans.roofline(w, COUNTERS, "k1_device_s")
