"""device.idle_pct.megablock: ``device.idle_pct`` of the megablock's cells, under the name that
moves ``encode_MBps.megablock``.  Device trace."""

from portbench.harness import load_reader

_base = load_reader("device.idle_pct")
read = _base.read
COUNTERS = getattr(_base, "COUNTERS", ())
