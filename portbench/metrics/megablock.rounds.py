"""megablock.rounds: doubling rounds of the sharded megablock
(``parallel.megablock.stats.rounds``) per encode.  Program counter."""

COUNTERS = ("archon_tpu_torch.parallel.megablock:stats.rounds",)


def read(w):
    return w.counters[COUNTERS[0]] / w.requests if w.requests else None
