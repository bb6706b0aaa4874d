"""container.fallback_rows_pct: rows the container recomputed through its
1-D fallback (``io.blocks._fallback_row.calls``) per 100 rows (blocks) the
window sent.  Program counter."""

COUNTERS = ("archon_tpu_torch.io.blocks:_fallback_row.calls",)


def read(w):
    if not w.rows:
        return None
    return 100.0 * w.counters[COUNTERS[0]] / w.rows
