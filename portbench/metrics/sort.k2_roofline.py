"""sort.k2_roofline: the share of its roofline at which K2
(``merge_partition_kernel`` and ``merge_level_kernel``) ran.  The least
time is the bytes its levels need for their real elements
(``ops.sort.merge_level.bytes``: the tuple read once and written once) over
the card's memory rate; the time taken is the device time of K2's events in
the window, the split pass included.  Device trace.  A program without the
counter reads nothing."""

from archon_tpu_torch.ops import sort as _sort
from portbench import spans

spans.install()
COUNTERS = ("archon_tpu_torch.ops.sort:merge_level.bytes",) if hasattr(_sort.merge_level, "bytes") else ()


def read(w):
    return spans.roofline(w, COUNTERS, "k2_device_s")
