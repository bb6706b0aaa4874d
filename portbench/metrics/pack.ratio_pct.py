"""pack.ratio_pct: payload bytes the pack wrote (``entropy.pack.stats.bytes_out``,
the method byte included) per 100 bytes of L it took (``stats.bytes_in``):
the size the users of ATA2 get, frame heads and bases left out.  Program
counter.  A program without the counters reads nothing."""

from archon_tpu_torch.entropy import pack as _pack

COUNTERS = (("archon_tpu_torch.entropy.pack:stats.bytes_out", "archon_tpu_torch.entropy.pack:stats.bytes_in")
            if hasattr(_pack, "stats") else ())


def read(w):
    if not COUNTERS or not w.counters[COUNTERS[1]]:
        return None
    return 100.0 * w.counters[COUNTERS[0]] / w.counters[COUNTERS[1]]
