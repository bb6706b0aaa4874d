"""sort_roofline: the share of their roofline at which the program's sorts
ran.  The least time is the bytes the sort calls need (every operand column
read once and every sorted column written once, at 4 B an element, counted
from the shapes of each outermost ``sort_operands``, ``sort_rows`` and
``merge_rows`` call) over the card's memory rate; the time taken is the
device time of every kernel, copy and fill those calls launched.  Device
trace."""

from portbench.peaks import HBM_BYTES_PER_S


def read(w):
    t = w.trace
    if t is None or not t.sort_bytes or not t.sort_device_s:
        return None
    return 100.0 * t.sort_bytes / HBM_BYTES_PER_S / t.sort_device_s
