"""pack.core_MBps: the rate of one thread of the pack's pool: the bytes of L
``entropy.pack.pack_block`` took (``stats.bytes_in``), in 10^6-byte units,
over the calls' own wall time summed over the threads (``stats.ns``).
Program counter.  A program without the counters reads nothing."""

from archon_tpu_torch.entropy import pack as _pack

COUNTERS = (("archon_tpu_torch.entropy.pack:stats.bytes_in", "archon_tpu_torch.entropy.pack:stats.ns")
            if hasattr(_pack, "stats") else ())


def read(w):
    if not COUNTERS or not w.counters[COUNTERS[1]]:
        return None
    return w.counters[COUNTERS[0]] / 1e6 / (w.counters[COUNTERS[1]] / 1e9)
