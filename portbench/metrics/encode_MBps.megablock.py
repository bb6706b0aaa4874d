"""encode_MBps.megablock: ``encode_MBps`` of the megablock's cells: the same reading under a name
of its own, since the megablock's rate spreads far less than the blocked
container's and carries a narrower bound.  Host clock."""

from portbench.harness import load_reader

_base = load_reader("encode_MBps")
read = _base.read
COUNTERS = getattr(_base, "COUNTERS", ())
