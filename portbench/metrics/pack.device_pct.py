"""pack.device_pct: blocks whose ATA2 payload was packed on the card where
their L lay (``entropy.pack.stats.device_blocks``) per 100 blocks packed
(``stats.blocks``): how often the device pack engages.  Program counter.  A
program without the counter reads nothing."""

from archon_tpu_torch.entropy import pack as _pack

COUNTERS = (("archon_tpu_torch.entropy.pack:stats.device_blocks", "archon_tpu_torch.entropy.pack:stats.blocks")
            if hasattr(getattr(_pack, "stats", None), "device_blocks") else ())


def read(w):
    if not COUNTERS or not w.counters[COUNTERS[1]]:
        return None
    return 100.0 * w.counters[COUNTERS[0]] / w.counters[COUNTERS[1]]
