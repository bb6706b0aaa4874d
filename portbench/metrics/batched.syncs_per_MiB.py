"""batched.syncs_per_MiB: host reads of the batched programs
(``core.batched.stats.host_syncs``) per MiB encoded.  Program counter."""

COUNTERS = ("archon_tpu_torch.core.batched:stats.host_syncs",)


def read(w):
    return w.counters[COUNTERS[0]] / (w.bytes_in / 2**20) if w.bytes_in else None
