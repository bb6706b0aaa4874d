"""megablock.stage_kernel_pct: merge-split stages of the sharded megablock
that ran through the stage merge's kernels
(``parallel.megablock.stats.stage_kernel``) per 100 stages run
(``stats.stages``): how often the stage kernel engages.  Program counter.  A
program without the counter reads nothing."""

from archon_tpu_torch.parallel import megablock as _megablock

COUNTERS = (("archon_tpu_torch.parallel.megablock:stats.stage_kernel",
             "archon_tpu_torch.parallel.megablock:stats.stages")
            if hasattr(getattr(_megablock, "stats", None), "stage_kernel") else ())


def read(w):
    if not COUNTERS or not w.counters[COUNTERS[1]]:
        return None
    return 100.0 * w.counters[COUNTERS[0]] / w.counters[COUNTERS[1]]
