"""sort.k2_roofline.megablock: ``sort.k2_roofline`` of the megablock's cells, under
the name that moves ``encode_MBps.megablock``.  Device trace."""

from portbench.harness import load_reader

_base = load_reader("sort.k2_roofline")
read = _base.read
COUNTERS = _base.COUNTERS
