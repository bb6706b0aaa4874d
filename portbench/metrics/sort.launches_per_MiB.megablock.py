"""sort.launches_per_MiB.megablock: ``sort.launches_per_MiB`` of the megablock's cells, under the
name that moves ``encode_MBps.megablock``.  Program counter."""

from portbench.harness import load_reader

_base = load_reader("sort.launches_per_MiB")
read = _base.read
COUNTERS = getattr(_base, "COUNTERS", ())
