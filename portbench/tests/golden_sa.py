"""Golden suffix array and BWT, pure numpy: a frozen copy of
``archon_tpu_torch/golden/sa.py`` (``suffix_array``, ``bwt_forward``), which
copies ``archon_tpu/golden/sa.py``.  The tests hold the benchmark's reference
to it; the benchmark itself never runs it.
"""

from __future__ import annotations

import numpy as np

SENT_SMALL = "small"  # end-of-string < every byte  (a4 convention)
SENT_LARGE = "large"  # end-of-string > every byte  (a7 convention)


def suffix_array(data: np.ndarray, sentinel: str = SENT_SMALL) -> np.ndarray:
    """Suffix array of ``data`` (uint8 array) by prefix doubling, O(n log^2 n).

    sentinel='small': on a prefix tie the shorter suffix sorts first
    (classic $-terminator semantics).
    sentinel='large': the longer suffix sorts first.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if sentinel not in (SENT_SMALL, SENT_LARGE):
        raise ValueError(f"bad sentinel {sentinel!r}")
    off_end = np.int64(-1) if sentinel == SENT_SMALL else np.int64(n + 0x100)
    rank = data.astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        rank2 = np.where(idx + k < n, rank[np.minimum(idx + k, n - 1)], off_end)
        order = np.lexsort((rank2, rank))
        r_s, r2_s = rank[order], rank2[order]
        head = np.ones(n, dtype=np.int64)
        head[1:] = (r_s[1:] != r_s[:-1]) | (r2_s[1:] != r2_s[:-1])
        new_rank_sorted = np.cumsum(head) - 1
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        if new_rank_sorted[-1] == n - 1:
            return order
        k *= 2


def bwt_forward(data: bytes | np.ndarray, sentinel: str) -> tuple[np.ndarray, int]:
    """Terminator-convention BWT of ``data``: returns (L, base).

    L[i] = data[(sa[i]-1) mod n]; base = rank of the full suffix (sa==0).
    """
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = len(arr)
    if n == 0:
        # Reference binaries refuse empty input (a4/src/archon.c:137); we
        # define the natural degenerate form: empty L, base 0.
        return np.zeros(0, dtype=np.uint8), 0
    sa = suffix_array(arr, sentinel)
    L = arr[(sa - 1) % n]
    base = int(np.nonzero(sa == 0)[0][0])
    return L, base


