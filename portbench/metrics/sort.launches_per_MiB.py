"""sort.launches_per_MiB: launches of the sort kernels, K1 and K2
(``ops.sort.sort_tiles.launches + merge_level.launches``), per MiB encoded.
Program counter."""

COUNTERS = ("archon_tpu_torch.ops.sort:sort_tiles.launches",
            "archon_tpu_torch.ops.sort:merge_level.launches")


def read(w):
    if not w.bytes_in:
        return None
    return sum(w.counters[c] for c in COUNTERS) / (w.bytes_in / 2**20)
